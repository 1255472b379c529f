"""Plain PyTorch versions of the port's kernels.

They run wherever PyTorch runs: the CPU path of ``kernels.ops`` takes them,
and on the card they are the oracle the CUDA kernels are held against.
``attention_bound`` states how closely the attention kernel is held.  (The
plain versions of the mesh kernels' forwards are
``core.photonic.mesh_apply_stacked`` and
``core.photonic.mesh_densify_stacked``, beside the mesh simulator, as in
the JAX package; the plain versions of their backwards,
``mesh_apply_grad_ref``, ``mesh_apply_dense_grad_ref`` and
``mesh_densify_grad_ref``, are here.)
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core import photonic as ph_lib
from repro_torch.core import tt as tt_lib
from repro_torch.kernels import quant as quant_lib

__all__ = ["tt_contract_ref", "tt_contract_grad_ref", "split_batch_axes",
           "tt_contract_batched_ref",
           "tt_contract_batched_quant_ref", "attention_ref",
           "attention_bound", "mesh_levels", "mesh_reverse",
           "mesh_apply_grad_ref", "mesh_apply_dense_grad_ref",
           "mesh_densify_grad_ref"]


def tt_contract_ref(x: torch.Tensor, cores: Sequence[torch.Tensor],
                    spec: tt_lib.TTSpec) -> torch.Tensor:
    """y = x @ W(cores)^T via the chain contraction (never densifies W)."""
    return tt_lib.tt_matvec(cores, x, spec)


def fiber_shapes(spec: tt_lib.TTSpec, k: int) -> tuple:
    """``(M_<k, N_>k)``: the fibers of step k run over the output modes
    before it and the input modes after it."""
    return (math.prod(spec.out_modes[:k]), math.prod(spec.in_modes[k + 1:]))


def _core_matrix(core: torch.Tensor) -> torch.Tensor:
    """G[r, m, n, r'] as the step's (r·n, m·r') matrix."""
    r, m, n, rn = core.shape
    return core.permute(0, 2, 1, 3).reshape(r * n, m * rn)


def tt_contract_grad_ref(x: torch.Tensor, cores: Sequence[torch.Tensor],
                         spec: tt_lib.TTSpec, dy: torch.Tensor,
                         need_dx: bool = True) -> tuple:
    """Plain version of ``tt_contract.tt_contract_grad``: the gradients of
    ``y = tt_contract_ref(x, cores, spec)`` against an upstream ``dy``
    (shaped like y), as the explicit reverse chain.

    Forward states ``A_k`` as ``(B·M_<k, N_>k, r·n_k)`` fibers (the rows of
    ``tt.tt_matvec``'s step k); then for k = L..1 ``dG_k = A_{k-1}ᵀ·dA_k``,
    reduced over the B·M_<k·N_>k fibers, and ``dA_{k-1} = dA_k·G_kᵀ``, with
    ``dA_L = dy`` and ``dx = dA_0``.  Returns ``(dx or None, [dG_k])``, each
    ``dG_k`` shaped like its core; the last step's ``dA_0`` is skipped
    without ``need_dx``."""
    B = math.prod(x.shape[:-1])
    states = []
    a = x.reshape(B, spec.in_dim)
    for k, (r, m, n, rn) in enumerate(spec.core_shapes):
        mp, ns = fiber_shapes(spec, k)
        a = a.reshape(B * mp, r * n, ns).transpose(1, 2)
        states.append(a)
        a = torch.matmul(a, _core_matrix(cores[k]))
        a = a.reshape(B * mp, ns, m, rn).permute(0, 2, 3, 1)
    d = dy.reshape(B, spec.out_dim)
    grads = [None] * spec.L
    for k in reversed(range(spec.L)):
        r, m, n, rn = spec.core_shapes[k]
        mp, ns = fiber_shapes(spec, k)
        dfib = d.reshape(B * mp, m, rn, ns).permute(0, 3, 1, 2).reshape(
            B * mp, ns, m * rn)
        dg = states[k].reshape(-1, r * n).T @ dfib.reshape(-1, m * rn)
        grads[k] = dg.reshape(r, n, m, rn).permute(0, 2, 1, 3).contiguous()
        if k or need_dx:
            da = torch.matmul(dfib, _core_matrix(cores[k]).T)  # (.., ns, r·n)
            d = da.transpose(1, 2).reshape(B * mp, r * n * ns)
    return (d.reshape(x.shape) if need_dx else None), grads


def split_batch_axes(x: torch.Tensor, P: int, spec: tt_lib.TTSpec,
                     shared_x: bool | None) -> tuple:
    """Resolve ``shared_x`` and flatten extra batch axes, as the TPU
    kernel's ``_split_batch_axes`` does: ``None`` infers shared for a 2-D
    x and per-entry (leading P axis) otherwise.  Returns
    ``(xf, batch_shape, shared)`` with xf ``(B, N)`` or ``(P, B, N)``."""
    if shared_x is None:
        shared_x = x.ndim == 2
    if shared_x:
        return x.reshape(-1, spec.in_dim), tuple(x.shape[:-1]), True
    if x.shape[0] != P:
        raise ValueError(f"x leading axis {x.shape[0]} != core stack P={P}")
    return x.reshape(P, -1, spec.in_dim), tuple(x.shape[1:-1]), False


def tt_contract_batched_ref(x: torch.Tensor, cores: Sequence[torch.Tensor],
                            spec: tt_lib.TTSpec,
                            shared_x: bool | None = None) -> torch.Tensor:
    """Plain version of the multi-perturbation kernel: the stacked chain
    over the leading core-stack axis, x shared ``(..., N)`` or per entry
    ``(P, ..., N)``; extra batch axes flatten and come back on the
    output ``(P, *batch_axes, M)``."""
    P = cores[0].shape[0]
    xf, batch_shape, _ = split_batch_axes(x, P, spec, shared_x)
    y = tt_lib.tt_matvec_stacked(cores, xf, spec)
    return y.reshape(P, *batch_shape, spec.out_dim)


def tt_contract_batched_quant_ref(x: torch.Tensor,
                                  cores: Sequence[torch.Tensor],
                                  spec: tt_lib.TTSpec,
                                  quant: quant_lib.QuantConfig,
                                  shared_x: bool | None = None
                                  ) -> torch.Tensor:
    """Plain version of ``tt_contract.tt_contract_batched_quant``: each of
    the P core variants fake-quantized with its own block scales, then the
    stacked f32 chain; x and the output as in
    ``tt_contract_batched_ref``."""
    fq = [quant_lib.fake_quant_stacked(c, quant) for c in cores]
    return tt_contract_batched_ref(x, fq, spec, shared_x)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Multi-head attention with GQA, causal and sliding-window masks: the
    function of the flash-attention kernel, computed whole.

    q: (B, H, Sq, D); k, v: (B, KH, Sk, D) with H % KH == 0 → (B, H, Sq, D)
    in q's dtype, f32 arithmetic.  Queries take the last Sq slots of the
    timeline: query i sits at ``i + Sk − Sq`` and sees key j where
    ``j ≤ i_abs`` (``causal``) and ``j > i_abs − window`` (``window`` not
    None).  A row that sees no key is zeros, as in the TPU kernel
    (``repro/kernels/flash_attention.py``, ``l == 0``); the JAX package's
    ``attention_ref`` gives NaN there.  Head h reads KV head
    ``h // (H // KH)``; no repeated K/V is materialized.
    """
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    if H % KH:
        raise ValueError(f"{H} query heads are not a multiple of {KH} KV "
                         "heads")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    # (B, KH, G·Sq, D): the G query heads of a KV head stacked as rows
    qg = q.float().reshape(B, KH, (H // KH) * Sq, D)
    s = torch.matmul(qg, k.float().transpose(-1, -2)).mul_(scale)
    q_abs = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    k_idx = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_idx <= q_abs
    if window is not None:
        mask &= k_idx > q_abs - window
    s = s.view(B, KH, H // KH, Sq, Sk).masked_fill_(~mask, -math.inf)
    p = torch.softmax(s, dim=-1).masked_fill_(~mask.any(-1, keepdim=True),
                                              0.0)
    out = torch.matmul(p.view(B, KH, (H // KH) * Sq, Sk), v.float())
    return out.view(B, H, Sq, D).to(q.dtype)


def attention_bound(plain: torch.Tensor) -> torch.Tensor:
    """Per element, how far the flash-attention kernel's output may sit from
    ``plain``, the output of ``attention_ref`` on the same inputs.

    f32: ``1e-5·max|plain| + 1e-6``, the same products and exponentials
    summed in another order.  bf16: that plus one bf16 ulp of the element's
    own |plain|, ``2^(⌊log2|plain|⌋ − 7)``: both sides round f32 values that
    may differ in their last bits, and a pair that straddles a rounding edge
    lands one ulp apart.  The ulp is the element's, not that of max|plain|,
    so small outputs (the late rows of a long causal row, ~0.02) are held
    as tightly as large ones.
    """
    a = plain.float().abs()
    bound = torch.full_like(a, 1e-5 * a.max().item() + 1e-6 if a.numel()
                            else 0.0)
    if plain.dtype == torch.bfloat16:
        bound += torch.exp2(torch.floor(torch.log2(a)) - 7)
    return bound


# ------------------------------------------------------------ mesh backwards

def mesh_levels(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                x: torch.Tensor, transpose: bool = False,
                states: list | None = None) -> torch.Tensor:
    """The levels of ``core.photonic.mesh_apply`` without its diag, in its
    arithmetic: phases ``(..., levels, slots)``, rows x ``(..., B, P)``.
    With ``states`` (a list), each level's input is appended to it in
    application order: the forward states a backward may keep."""
    cos, sin = ph_lib.mesh_gather_tables(layout, phases, transpose)
    perm = ph_lib.mesh_plan_tensors(layout, x.device)[
        "perm_t" if transpose else "perm"]
    cos, sin = cos[..., None, :], sin[..., None, :]
    for c in range(layout.levels):
        if states is not None:
            states.append(x)
        x = cos[..., c, :, :] * x + sin[..., c, :, :] * x[..., perm[c]]
    return x


def mesh_reverse(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                 y: torch.Tensor, g: torch.Tensor, transpose: bool = False,
                 states: list | None = None) -> tuple:
    """The reverse walk of ``mesh_levels``, the algorithm of the mesh
    backward kernels (``csrc/mesh_apply.cu::reverse_levels``).

    ``y`` is the levels' output and ``g`` the gradient there, rows
    ``(..., B, P)``.  Level by level, last first, it takes the level's
    input — ``states[c]`` where the forward kept them, else recovered from
    its output by the inverse rotation, ``x[w] = C[w]·y[w] − S[w]·y[perm
    w]`` (each level is orthogonal; the recovered states differ from the
    forward's by rounding, a few ulps a level) — adds each slot's
    ``Σ_rows Σ_{its two wires} g[w]·∂y[w]/∂φ`` to its phase gradient,
    with ``∂y[w]/∂φ = −sin φ·x[w] + σ·sign[w]·cos φ·x[perm w]`` (σ = −1
    when transposed, whose sines are negated), and carries the gradient
    through, ``g ← Mᵀg``: ``g[w] ← C[w]·g[w] − S[w]·g[perm w]``.  Returns
    ``(g at the levels' input, dphases (..., levels, slots))``."""
    P, L, K = layout.ports, layout.levels, layout.slots
    plan = ph_lib.mesh_plan_tensors(layout, y.device)
    cos_t, sin_t = ph_lib.mesh_gather_tables(layout, phases, transpose)
    perm = plan["perm_t" if transpose else "perm"]
    sign, slot = plan["sign"], plan["slot"]
    ph = torch.gather(phases, -1, slot.expand(*phases.shape[:-1], P))
    cs, sn = torch.cos(ph), torch.sin(ph)                   # stored order
    coef = -sign if transpose else sign
    paired = (sign != 0.0).to(y.dtype)
    dph = torch.zeros((*phases.shape[:-1], K), dtype=y.dtype,
                      device=y.device)
    for c in reversed(range(L)):
        cl = L - 1 - c if transpose else c
        C = cos_t[..., c, None, :]
        S = sin_t[..., c, None, :]
        pc = perm[c]
        x = states[c] if states is not None else C * y - S * y[..., pc]
        term = g * (-sn[..., cl, None, :] * x
                    + coef[cl] * cs[..., cl, None, :] * x[..., pc])
        per_wire = (term * paired[cl]).sum(-2)                     # (..., P)
        dph[..., cl, :] = torch.zeros_like(dph[..., cl, :]).scatter_add_(
            -1, slot[cl].expand_as(per_wire), per_wire)
        g = C * g - S * g[..., pc]
        y = x
    return g, dph


def mesh_apply_grad_ref(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                        diag: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                        dy: torch.Tensor, transpose: bool = False) -> tuple:
    """Plain version of ``mesh_apply.mesh_apply_stacked_grad``: the
    gradients of ``y = photonic.mesh_apply_stacked(layout, phases, diag, x,
    transpose)`` against ``dy``, by ``mesh_reverse`` from y (no forward
    state kept).  phases ``(S, levels, slots)``, diag ``(P,)`` or ``(S,
    P)``, x ``(B, P)`` shared or ``(S, B, P)`` (its shape only: a shared
    x's gradient sums over the stack), y and dy ``(S, B, P)``.  The diag
    comes first in the forward, so the walk ends with it; transposed it
    comes last, so the walk starts from ``y / diag`` and ``dy·diag`` (exact
    for the ±1 buffers).  Returns ``(dx shaped like x, dphases)``."""
    d = diag[..., None, :] if diag.ndim == 2 else diag
    if transpose:
        g, dph = mesh_reverse(layout, phases, y / d, dy * d, True)
        dx = g
    else:
        g, dph = mesh_reverse(layout, phases, y, dy, False)
        dx = g * d
    return (dx.sum(0) if x.ndim == 2 else dx), dph


def mesh_apply_dense_grad_ref(layout: ph_lib.MeshLayout,
                              phases: torch.Tensor, diag: torch.Tensor,
                              x: torch.Tensor, dense: torch.Tensor,
                              dy: torch.Tensor,
                              transpose: bool = False) -> tuple:
    """Plain version of ``mesh_apply_stacked_grad``'s dense design, the
    backward of route B's forward y_s = x_s·M_s from x and M ``(S, P,
    P)`` (row i of M_s the mesh on e_i, as ``mesh_apply.launch_dense_keep``
    keeps it): ``dx_s = dy_s·M_sᵀ`` (summed over S for a shared x) and
    ``dM_s = x_sᵀ·dy_s``, then dphases by ``mesh_apply_grad_ref`` on M's
    P identity rows (y := M, dy := dM).  Returns ``(dx shaped like x,
    dphases)``."""
    dx = dy @ dense.transpose(-1, -2)
    dM = x.transpose(-1, -2) @ dy
    eye = torch.eye(layout.ports, dtype=torch.float32, device=x.device)
    _, dph = mesh_apply_grad_ref(layout, phases, diag, eye.expand(
        dense.shape[0], -1, -1), dense, dM, transpose)
    return (dx.sum(0) if x.ndim == 2 else dx), dph


def _noise_transpose(noise_model: ph_lib.NoiseModel, noise: dict,
                     d: torch.Tensor) -> torch.Tensor:
    """The gradient of ``NoiseModel.effective_phases`` carried to the
    commanded phases: Ω is symmetric (tridiagonal over a level's slots,
    weight κ), so ``Γ ⊙ (d + κ·(d[k−1] + d[k+1]))``."""
    if noise_model.crosstalk > 0.0 and d.shape[-1] > 1:
        left = torch.nn.functional.pad(d[..., 1:], (0, 1))
        right = torch.nn.functional.pad(d[..., :-1], (1, 0))
        d = d + noise_model.crosstalk * (left + right)
    return noise["gamma"] * d


def mesh_densify_grad_ref(matrices: Sequence[ph_lib.PhotonicMatrix],
                          params: Sequence[dict], noises: Sequence,
                          noise_model: ph_lib.NoiseModel | None,
                          dW: Sequence[torch.Tensor],
                          saved: Sequence[bool] | bool = True) -> list:
    """Plain version of ``mesh_apply.mesh_densify_grad``: the gradients of
    ``photonic.mesh_densify_stacked(matrices, params, noises,
    noise_model)`` (no DAC snap) against the upstream ``dW[g]`` ``(S,
    out_dim, in_dim)``, with respect to the COMMANDED phases and sigma.

    Per matrix, as the kernel's block: V transposed on the identity, then
    σ, the zero pad and U, keeping each level's input where ``saved[g]``
    (else ``mesh_reverse`` recovers them from the output); the reverse
    walk of U from ``g = dWᵀ`` gives dφ_U and the gradient at U's input
    rows, whose first k wires give ``dσ = Σ_rows (a·D_v)·(g·D_u)`` and V's
    output gradient ``((g·D_u)·σ)·D_v``; the reverse walk of V gives dφ_V.
    With the noise model on, both are carried to the commanded phases
    (``_noise_transpose``).  Returns ``[(dphases_u, dphases_v, dsigma)]``
    per matrix."""
    if isinstance(saved, bool):
        saved = [saved] * len(matrices)
    out = []
    for pm, p, nz, dw, keep in zip(matrices, params, noises, dW, saved,
                                   strict=True):
        noisy = (noise_model is not None and noise_model.enabled
                 and nz is not None)
        pu, pv = p["phases_u"], p["phases_v"]
        if noisy:
            pu = noise_model.effective_phases(pu, nz["u"])
            pv = noise_model.effective_phases(pv, nz["v"])
        S, k = p["sigma"].shape[0], pm.k
        eye = torch.eye(pm.in_dim, dtype=torch.float32,
                        device=pu.device).expand(S, -1, -1)
        dv = p["diag_v"][..., None, :] if p["diag_v"].ndim == 2 \
            else p["diag_v"]
        du = p["diag_u"][..., None, :] if p["diag_u"].ndim == 2 \
            else p["diag_u"]
        sig = p["sigma"][:, None, :]
        sv = [] if keep else None
        a = mesh_levels(pm.layout_v, pv, eye, True, sv)        # (S, in, in)
        av = a[..., :k] * dv[..., :k]
        z = torch.nn.functional.pad(av * sig, (0, pm.out_dim - k)) * du
        su = [] if keep else None
        r = mesh_levels(pm.layout_u, pu, z, False, su)         # (S, in, out)
        g, dph_u = mesh_reverse(pm.layout_u, pu, r, dw.transpose(-1, -2),
                                False, su)
        gz = g[..., :k] * du[..., :k]
        dsig = (av * gz).sum(-2)
        da = torch.nn.functional.pad((gz * sig) * dv[..., :k],
                                     (0, pm.in_dim - k))
        _, dph_v = mesh_reverse(pm.layout_v, pv, a, da, True, sv)
        if noisy:
            dph_u = _noise_transpose(noise_model, nz["u"], dph_u)
            dph_v = _noise_transpose(noise_model, nz["v"], dph_v)
        out.append((dph_u, dph_v, dsig))
    return out
