"""Photonic MZI-mesh simulator.

A weight matrix ``W = U Σ Vᵀ`` is realized by two meshes of 2×2 MZI
rotators; hardware imperfections act on the phases,
``Φ_eff = Ω (Γ ⊙ Φ) + Φ_b`` (``NoiseModel``).  The densification of a
``tonn`` model's (small) core meshes into TT-cores — all N+1
SPSA-perturbed phase sets at once in training, a stack of one at serving
load — goes through ``kernels.ops.mesh_densify_stacked`` (one launch of the
grouped CUDA kernel on the card, ``mesh_densify_stacked``'s plain loop
here on the CPU).  ``PhotonicMatrix.apply`` and ``apply_stacked`` — the
``onn`` mode's layers, whose meshes are as wide as the hidden layer — run
through ``kernels.ops.mesh_apply`` and ``mesh_apply_stacked`` the same
way, and on the card so do their backwards where autograd needs them.
``to_dense`` is the plain, differentiable densification (autograd through
``mesh_apply``), the oracle of the grouped kernels.  A ``quant``
with ``phase_bits`` snaps the commanded phases to the DAC grid before the
noise model acts.

``decompose_orthogonal`` maps an orthogonal matrix onto a (Reck-ordered)
mesh, ``PhotonicMatrix.from_dense`` a trained dense matrix onto a pair of
them; ``mesh_apply_scan`` is the scatter-per-level formulation, kept as
the sequential photonic-realism oracle of the gather form.  The
decomposition runs in numpy float64, as the JAX package's does.

Port of ``repro.core.photonic``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import quant as quant_lib

__all__ = ["PHOTONIC_BUFFER_KEYS", "MeshLayout", "schedule_ops",
           "rectangular_layout", "decompose_orthogonal", "mesh_gather_plan",
           "mesh_owner_plan", "mesh_plan_tensors", "mesh_gather_tables",
           "mesh_apply", "mesh_apply_scan", "mesh_apply_stacked",
           "mesh_matrix", "mesh_matrix_stacked", "NoiseModel",
           "PhotonicMatrix", "mesh_densify_stacked", "mzi_count_matrix"]

# fixed ±1 buffers of a PhotonicMatrix's params: they pin each mesh to its
# orthogonal decomposition, and ZO training neither perturbs nor updates
# them (``TensorPinn.trainable_mask``)
PHOTONIC_BUFFER_KEYS = ("diag_u", "diag_v")


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Leveled mesh: level ``c`` applies rotations on wire pairs
    ``(idx_a[c,k], idx_b[c,k])`` for every unmasked slot ``k``.
    Padded slots point at the scratch wire ``P``."""

    ports: int
    idx_a: np.ndarray  # (levels, slots) int32
    idx_b: np.ndarray  # (levels, slots) int32
    mask: np.ndarray   # (levels, slots) bool

    @property
    def levels(self) -> int:
        return self.idx_a.shape[0]

    @property
    def slots(self) -> int:
        return self.idx_a.shape[1]

    @property
    def num_mzis(self) -> int:
        return int(self.mask.sum())

    def phase_shape(self) -> tuple:
        return (self.levels, self.slots)


def schedule_ops(ports: int, ops: Sequence[tuple]) -> MeshLayout:
    """Greedy level-schedule an ordered rotation list [(a, b), ...] into
    columns of disjoint pairs, preserving relative order on shared wires."""
    wire_level = np.full(ports, -1, dtype=np.int64)
    levels: list = []
    for (a, b) in ops:
        lvl = int(max(wire_level[a], wire_level[b])) + 1
        while len(levels) <= lvl:
            levels.append([])
        levels[lvl].append((a, b))
        wire_level[a] = lvl
        wire_level[b] = lvl
    n_levels = max(1, len(levels))
    slots = max(1, max((len(l) for l in levels), default=1))
    idx_a = np.full((n_levels, slots), ports, dtype=np.int32)
    idx_b = np.full((n_levels, slots), ports, dtype=np.int32)
    mask = np.zeros((n_levels, slots), dtype=bool)
    for c, lvl in enumerate(levels):
        for k, (a, b) in enumerate(lvl):
            idx_a[c, k] = a
            idx_b[c, k] = b
            mask[c, k] = True
    return MeshLayout(ports=ports, idx_a=idx_a, idx_b=idx_b, mask=mask)


@functools.cache
def rectangular_layout(ports: int) -> MeshLayout:
    """Clements-style rectangular arrangement: ``ports`` columns alternating
    even/odd pair offsets; exactly P(P-1)/2 MZIs.  One object per width,
    so every matrix of that width shares the plan memoized on it.  Built
    in closed form: the layout ``schedule_ops`` makes of the columns'
    pairs in order."""
    # what schedule_ops makes of column c's pairs (a, a+1), a ≡ c mod 2,
    # in order: level c (an empty column, at 2 ports, adds none), slot k
    # the k-th pair, padded slots on the scratch wire
    if ports < 2:
        return schedule_ops(ports, [])
    levels = ports if ports > 2 else 1
    slots = ports // 2
    c, k = np.meshgrid(np.arange(levels), np.arange(slots), indexing="ij")
    a = c % 2 + 2 * k
    mask = a + 1 < ports
    idx_a = np.where(mask, a, ports).astype(np.int32)
    idx_b = np.where(mask, a + 1, ports).astype(np.int32)
    layout = MeshLayout(ports=ports, idx_a=idx_a, idx_b=idx_b, mask=mask)
    if layout.num_mzis != ports * (ports - 1) // 2:
        raise AssertionError(f"rectangular layout has {layout.num_mzis} MZIs")
    return layout


def decompose_orthogonal(u: np.ndarray) -> tuple:
    """Givens-QR (Reck-ordered) decomposition of a real orthogonal matrix,
    in float64: ``(layout, phases, diag)`` with ``mesh_matrix(layout,
    phases, diag) == u`` up to float error (phases and diag float32
    tensors).  Nulling ``G_K … G_1 U = D`` (D diagonal ±1) gives
    ``U = G_1ᵀ … G_Kᵀ D``: D is applied first, then the ``Gᵀ`` in reverse
    nulling order."""
    u = np.asarray(u, dtype=np.float64)
    P = u.shape[0]
    if u.shape != (P, P):
        raise ValueError(f"need a square matrix, got {u.shape}")
    r = u.copy()
    nulling: list = []                     # (a, b, theta) in nulling order
    for c in range(P - 1):
        for row in range(P - 1, c, -1):
            a, b = row - 1, row
            theta = (0.0 if abs(r[b, c]) < 1e-300
                     else math.atan2(r[b, c], r[a, c]))
            ca, sa = math.cos(theta), math.sin(theta)
            # G = [[ca, sa], [-sa, ca]] on rows (a, b) zeroes r[b, c]
            ra, rb = r[a].copy(), r[b].copy()
            r[a] = ca * ra + sa * rb
            r[b] = -sa * ra + ca * rb
            nulling.append((a, b, theta))
    diag = np.sign(np.diag(r))
    diag[diag == 0] = 1.0
    # application order: reversed nulling, each Gᵀ the mesh rotation
    # R(theta) = [[cos, -sin], [sin, cos]]
    ops = [(a, b) for (a, b, _) in reversed(nulling)]
    layout = schedule_ops(P, ops)
    phases = np.zeros(layout.phase_shape(), dtype=np.float64)
    # refill the phases in the traversal order of schedule_ops
    wire_level = np.full(P, -1, dtype=np.int64)
    counters = np.zeros(layout.levels, dtype=np.int64)
    for (a, b, theta) in reversed(nulling):
        lvl = int(max(wire_level[a], wire_level[b])) + 1
        k = counters[lvl]
        counters[lvl] += 1
        phases[lvl, k] = theta
        wire_level[a] = lvl
        wire_level[b] = lvl
    return (layout, torch.tensor(phases.astype(np.float32)),
            torch.tensor(diag.astype(np.float32)))


def mesh_gather_plan(layout: MeshLayout) -> tuple:
    """Static per-level gather plan ``(perm, slot, sign)``, each
    ``(levels, ports)``: the wire paired with ``w`` (``w`` itself when
    unpaired), the slot of the MZI acting on ``w``, and −1 / +1 / 0 on the
    first lane of a pair / the second / an unpaired wire.  Memoized on the
    (frozen) layout."""
    plan = getattr(layout, "_gather_plan", None)
    if plan is not None:
        return plan
    P = layout.ports
    L = layout.levels
    perm = np.tile(np.arange(P, dtype=np.int32), (L, 1))
    slot = np.zeros((L, P), dtype=np.int32)
    sign = np.zeros((L, P), dtype=np.float32)
    # the pairs of a level are disjoint: one scatter sets every wire
    c, k = np.nonzero(layout.mask)
    a, b = layout.idx_a[c, k], layout.idx_b[c, k]
    perm[c, a], perm[c, b] = b, a
    slot[c, a] = slot[c, b] = k
    sign[c, a], sign[c, b] = -1.0, 1.0
    plan = (perm, slot, sign)
    object.__setattr__(layout, "_gather_plan", plan)
    return plan


def mesh_owner_plan(layout: MeshLayout) -> np.ndarray:
    """The wires that own an update at each level, ``(levels, items)``
    int32: the first lane of every MZI in slot order, then every unpaired
    wire in ascending order, padded with −1.  Level c's owner ``a``
    updates ``a`` and its partner ``perm[c, a]`` (itself when unpaired), so
    the owners of a level touch disjoint wires and cover every wire once:
    the owner walk's work list (the wide mesh route for layouts whose
    pairs are not adjacent).  Memoized on the layout."""
    owner = getattr(layout, "_owner_plan", None)
    if owner is not None:
        return owner
    P, L = layout.ports, layout.levels
    rows = []
    for c in range(L):
        m = layout.mask[c]
        paired = np.zeros(P, dtype=bool)
        paired[layout.idx_a[c, m]] = paired[layout.idx_b[c, m]] = True
        rows.append(np.concatenate([layout.idx_a[c, m],
                                    np.flatnonzero(~paired)]))
    owner = np.full((L, max(len(r) for r in rows)), -1, dtype=np.int32)
    for c, r in enumerate(rows):
        owner[c, :len(r)] = r
    object.__setattr__(layout, "_owner_plan", owner)
    return owner


def mesh_plan_tensors(layout: MeshLayout, device: torch.device) -> dict:
    """The gather plan as tensors on ``device``: ``slot`` (int64) and
    ``sign`` (float32) for the trig tables, ``slot_i32`` (the kernels'
    int32 copy of ``slot``), ``perm`` and ``perm_t`` (int32, the wire each
    output wire reads per level, in application order without and with
    ``transpose``) and ``owner`` (``mesh_owner_plan``).  Memoized on the (frozen) layout, so a mesh call
    copies nothing from the host (a copy from pageable host memory waits
    for the card)."""
    memo = layout.__dict__.setdefault("_plan_tensors", {})
    if device not in memo:
        perm, slot, sign = mesh_gather_plan(layout)
        memo[device] = {
            "slot": torch.as_tensor(slot, dtype=torch.int64, device=device),
            "slot_i32": torch.as_tensor(slot, dtype=torch.int32,
                                        device=device),
            "sign": torch.as_tensor(sign, device=device),
            "perm": torch.as_tensor(perm, dtype=torch.int32, device=device),
            # a copy: a one-level flip keeps its negative stride through
            # np.ascontiguousarray, and torch refuses negative strides
            "perm_t": torch.as_tensor(perm[::-1].copy(), dtype=torch.int32,
                                      device=device),
            "owner": torch.as_tensor(mesh_owner_plan(layout),
                                     device=device)}
    return memo[device]


def mesh_gather_tables(layout: MeshLayout, phases: torch.Tensor,
                       transpose: bool = False) -> tuple:
    """Per-wire trig tables ``(C, S)``, each ``(..., levels, ports)``, for
    phases ``(..., levels, slots)`` with any leading stack axes — in
    APPLICATION order (``transpose`` reverses the level axis and negates
    the sines)."""
    plan = mesh_plan_tensors(layout, phases.device)
    idx = plan["slot"].expand(*phases.shape[:-1], layout.ports)
    ph = torch.gather(phases, -1, idx)                          # (..., L, P)
    sign = plan["sign"]
    cos = torch.where(sign != 0.0, torch.cos(ph), torch.ones_like(ph))
    sin = sign * torch.sin(ph)                                  # sign 0 → 0
    if transpose:
        cos = torch.flip(cos, dims=(-2,))
        sin = -torch.flip(sin, dims=(-2,))
    return cos, sin


def mesh_apply(layout: MeshLayout, phases: torch.Tensor, diag: torch.Tensor,
               x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Apply the mesh unitary ``U`` (or ``Uᵀ``) to ``x`` with trailing dim P.

    Gather form: ``x ← D x``, then per level
    ``y[w] = C[c, w] · x[w] + S[c, w] · x[perm[c, w]]``.  ``transpose=True``
    runs the levels in reverse with negated angles and applies D last.
    ``phases (..., levels, slots)``, ``diag (..., P)`` and ``x (..., B, P)``
    may carry leading stack axes that broadcast against each other.
    """
    cos, sin = mesh_gather_tables(layout, phases, transpose)
    perm_seq = mesh_plan_tensors(layout, x.device)[
        "perm_t" if transpose else "perm"]
    diag = diag.to(x.dtype)[..., None, :]
    if not transpose:
        x = x * diag
    cos = cos.to(x.dtype)[..., None, :]                 # (..., L, 1, P)
    sin = sin.to(x.dtype)[..., None, :]
    for c in range(layout.levels):
        # a gather by advanced indexing (exact, as index_select, and ~20x
        # faster on the CPU along the last axis)
        x = cos[..., c, :, :] * x + sin[..., c, :, :] * x[..., perm_seq[c]]
    if transpose:
        x = x * diag
    return x


def mesh_apply_stacked(layout: MeshLayout, phases: torch.Tensor,
                       diag: torch.Tensor, x: torch.Tensor,
                       transpose: bool = False) -> torch.Tensor:
    """``mesh_apply`` with a leading stack axis on the phases — the plain
    version of ``kernels.mesh_apply.mesh_apply_stacked``.

    phases ``(S, levels, slots)``, one set per SPSA perturbation; diag
    ``(P,)`` shared or ``(S, P)``; x ``(B, P)`` shared across the stack
    (the identity feed of a densification) or ``(S, B, P)``.  Returns
    ``(S, B, P)``.
    """
    S = phases.shape[0]
    if x.ndim == 2:
        x = x.expand(S, *x.shape)
    if diag.ndim == 1:
        diag = diag.expand(S, diag.shape[0])
    return mesh_apply(layout, phases, diag, x, transpose)


def mesh_apply_scan(layout: MeshLayout, phases: torch.Tensor,
                    diag: torch.Tensor, x: torch.Tensor,
                    transpose: bool = False) -> torch.Tensor:
    """The scatter-per-level formulation: one rotation column at a time,
    as light crosses the physical mesh — the sequential photonic-realism
    oracle of the gather form (``mesh_apply``), which applies the same
    rotations and agrees to f32 rounding.  phases ``(levels, slots)``,
    diag ``(P,)``, x ``(..., P)``."""
    P = layout.ports
    batch_shape = x.shape[:-1]
    # a scratch wire at index P absorbs the padded slots
    xf = x.reshape(-1, P)
    xf = torch.cat([xf, xf.new_zeros((xf.shape[0], 1))], dim=-1)
    d = torch.cat([diag.to(x.dtype), diag.new_ones(1).to(x.dtype)])
    idx_a = torch.as_tensor(layout.idx_a, dtype=torch.int64, device=x.device)
    idx_b = torch.as_tensor(layout.idx_b, dtype=torch.int64, device=x.device)
    mask = torch.as_tensor(layout.mask, device=x.device)
    if not transpose:
        xf = xf * d
    order = range(layout.levels - 1, -1, -1) if transpose \
        else range(layout.levels)
    for c in order:
        ph = -phases[c] if transpose else phases[c]
        ia, ib, m = idx_a[c], idx_b[c], mask[c]
        a, b = xf[:, ia], xf[:, ib]
        cs, sn = torch.cos(ph).to(x.dtype), torch.sin(ph).to(x.dtype)
        na = torch.where(m, cs * a - sn * b, a)
        nb = torch.where(m, sn * a + cs * b, b)
        xf = xf.clone()      # repeated indices only name the scratch wire
        xf[:, ia] = na
        xf[:, ib] = nb
    if transpose:
        xf = xf * d
    return xf[:, :P].reshape(*batch_shape, P)


def mesh_matrix(layout: MeshLayout, phases: torch.Tensor,
                diag: torch.Tensor) -> torch.Tensor:
    """The mesh unitary made dense: ``U[:, j] = mesh_apply(e_j)``."""
    eye = torch.eye(layout.ports, dtype=torch.float32, device=phases.device)
    return mesh_apply(layout, phases, diag, eye).T


def mesh_matrix_stacked(layout: MeshLayout, phases: torch.Tensor,
                        diag: torch.Tensor) -> torch.Tensor:
    """S stacked mesh unitaries made dense in one pass that shares the
    identity feed: phases ``(S, levels, slots)`` → ``(S, P, P)``, entry s
    ``mesh_matrix(layout, phases[s], diag[s])``."""
    eye = torch.eye(layout.ports, dtype=torch.float32, device=phases.device)
    return mesh_apply_stacked(layout, phases, diag, eye).transpose(-1, -2)


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Paper §4.1 hardware imperfections, applied in the phase domain."""

    gamma_mean: float = 1.0     # γ nominal
    gamma_std: float = 0.002    # σ_γ fabrication drift
    crosstalk: float = 0.005    # κ: thermal coupling to adjacent MZIs
    phase_bias_scale: float = 1.0  # β·U(0,2π)
    enabled: bool = True

    def sample(self, generator: torch.Generator, phase_shape: tuple) -> dict:
        """One chip's fixed noise, drawn on the CPU from ``generator``."""
        if not self.enabled:
            return {"gamma": torch.ones(phase_shape),
                    "bias": torch.zeros(phase_shape)}
        gamma = self.gamma_mean + self.gamma_std * torch.randn(
            phase_shape, generator=generator)
        bias = self.phase_bias_scale * (2.0 * math.pi) * torch.rand(
            phase_shape, generator=generator)
        return {"gamma": gamma, "bias": bias}

    def effective_phases(self, phases: torch.Tensor, noise: dict) -> torch.Tensor:
        """Φ_eff = Ω (Γ ⊙ Φ) + Φ_b, Ω mixing adjacent slots of a level."""
        if not self.enabled:
            return phases
        p = noise["gamma"] * phases
        if self.crosstalk > 0.0 and p.shape[-1] > 1:
            left = torch.nn.functional.pad(p[..., 1:], (0, 1))
            right = torch.nn.functional.pad(p[..., :-1], (1, 0))
            p = p + self.crosstalk * (left + right)
        return p + noise["bias"]


class PhotonicMatrix:
    """An (out_dim × in_dim) matrix realized as U(Φ_U) Σ Vᵀ(Φ_V).

    Layouts live on the object; the params dict holds the phases, sigma and
    the fixed ±1 ``diag_u``/``diag_v`` buffers.
    """

    def __init__(self, out_dim: int, in_dim: int):
        self.out_dim = out_dim
        self.in_dim = in_dim
        self.layout_u = rectangular_layout(out_dim)
        self.layout_v = rectangular_layout(in_dim)
        self.k = min(out_dim, in_dim)

    def init(self, generator: torch.Generator, scale: float | None = None) -> dict:
        """Random phases (a Haar-ish orthogonal pair) and a sigma setting
        the scale, drawn on the CPU from ``generator``."""
        std = scale if scale is not None else math.sqrt(
            2.0 / (self.in_dim + self.out_dim))
        return {
            "phases_u": 0.1 * torch.randn(self.layout_u.phase_shape(),
                                          generator=generator),
            "phases_v": 0.1 * torch.randn(self.layout_v.phase_shape(),
                                          generator=generator),
            "sigma": std * math.sqrt(float(self.k)) * torch.abs(
                1.0 + 0.1 * torch.randn((self.k,), generator=generator)),
            "diag_u": torch.ones((self.out_dim,)),
            "diag_v": torch.ones((self.in_dim,)),
        }

    def from_dense(self, w: np.ndarray) -> dict:
        """Map a trained dense W onto hardware phases (the off-chip path):
        an SVD in float64, each orthogonal factor decomposed onto a mesh
        (``decompose_orthogonal``), whose layouts replace this matrix's."""
        w = np.asarray(w, dtype=np.float64)
        if w.shape != (self.out_dim, self.in_dim):
            raise ValueError(f"need a ({self.out_dim}, {self.in_dim}) "
                             f"matrix, got {w.shape}")
        u, s, vt = np.linalg.svd(w, full_matrices=True)
        lu, pu, du = decompose_orthogonal(u)
        lv, pv, dv = decompose_orthogonal(vt.T)
        self.layout_u, self.layout_v = lu, lv
        return {"phases_u": pu, "phases_v": pv,
                "sigma": torch.tensor(s[:self.k].astype(np.float32)),
                "diag_u": du, "diag_v": dv}

    @property
    def num_mzis(self) -> int:
        return self.layout_u.num_mzis + self.layout_v.num_mzis

    @staticmethod
    def _dac_phases(pu: torch.Tensor, pv: torch.Tensor, quant) -> tuple:
        """Snap the COMMANDED phases to the DAC grid (``quant.phase_bits``)
        before the noise model acts: the DAC drives the shifter, then the
        chip's imperfections corrupt what it commanded,
        Φ_eff = Ω(Γ ⊙ Q(Φ)) + Φ_b.  Passes them through when phase
        quantization is off."""
        if quant is None or not quant.phases:
            return pu, pv
        return (quant_lib.quantize_phases(pu, quant.phase_bits),
                quant_lib.quantize_phases(pv, quant.phase_bits))

    def _apply(self, params: dict, x: torch.Tensor, noise_model, noise,
               quant, mesh) -> torch.Tensor:
        pu, pv = self._dac_phases(params["phases_u"], params["phases_v"],
                                  quant)
        if noise_model is not None and noise is not None:
            # one physical chip: the noise broadcasts over any stack axis
            pu = noise_model.effective_phases(pu, noise["u"])
            pv = noise_model.effective_phases(pv, noise["v"])
        z = mesh(self.layout_v, pv, params["diag_v"], x, transpose=True)
        z = z[..., :self.k] * params["sigma"].to(z.dtype)[..., None, :]
        if self.out_dim > self.k:
            z = torch.nn.functional.pad(z, (0, self.out_dim - self.k))
        return mesh(self.layout_u, pu, params["diag_u"], z)

    def apply(self, params: dict, x: torch.Tensor,
              noise_model: NoiseModel | None = None,
              noise: dict | None = None, quant=None) -> torch.Tensor:
        """y = U Σ Vᵀ x for x ``(B, in_dim)``; ``quant`` with
        ``phase_bits`` snaps the commanded phases first.  The meshes run
        through ``kernels.ops.mesh_apply``."""
        from repro_torch.kernels import ops   # ops imports this module
        return self._apply(params, x, noise_model, noise, quant,
                           ops.mesh_apply)

    def apply_stacked(self, params: dict, x: torch.Tensor,
                      noise_model: NoiseModel | None = None,
                      noise: dict | None = None, quant=None) -> torch.Tensor:
        """``apply`` over a leading SPSA-perturbation axis S on the params
        (phases and sigma stacked; diag buffers ``(P,)`` or ``(S, P)``): x
        ``(B, in)`` shared or ``(S, B, in)`` → ``(S, B, out)``.  The meshes
        run through ``kernels.ops.mesh_apply_stacked``."""
        from repro_torch.kernels import ops   # ops imports this module
        return self._apply(params, x, noise_model, noise, quant,
                           ops.mesh_apply_stacked)

    def sample_noise(self, generator: torch.Generator, model: NoiseModel) -> dict:
        return {"u": model.sample(generator, self.layout_u.phase_shape()),
                "v": model.sample(generator, self.layout_v.phase_shape())}

    def to_dense(self, params: dict, noise_model: NoiseModel | None = None,
                 noise: dict | None = None, quant=None) -> torch.Tensor:
        """W ``(out, in)`` through the plain gather form (``mesh_apply``)
        on any device, which autograd differentiates: the plain
        densification ``TensorPinn.prepare_params_plain`` holds the
        grouped kernels and their backward against."""
        eye = torch.eye(self.in_dim, dtype=torch.float32,
                        device=params["sigma"].device)
        return self._apply(params, eye, noise_model, noise, quant,
                           mesh_apply).T                     # row j = W e_j

    def to_dense_stacked(self, params: dict,
                         noise_model: NoiseModel | None = None,
                         noise: dict | None = None,
                         quant=None) -> torch.Tensor:
        """Densify S stacked parameter sets in one batched pass that shares
        the identity feed: ``(S, out, in)``, entry s the ``to_dense`` of
        the s-th params."""
        eye = torch.eye(self.in_dim, dtype=torch.float32,
                        device=params["sigma"].device)
        return self.apply_stacked(params, eye, noise_model, noise,
                                  quant).transpose(-1, -2)


def mesh_densify_stacked(matrices: Sequence[PhotonicMatrix],
                         params: Sequence[dict], noises: Sequence,
                         noise_model: NoiseModel | None = None,
                         quant=None) -> list:
    """``to_dense_stacked`` of G photonic matrices — the plain version of
    ``kernels.mesh_apply.mesh_densify_stacked``.

    ``params[g]`` is matrix g's stacked params (phases and sigma with a
    leading axis S, diag buffers ``(P,)`` or ``(S, P)``), ``noises[g]``
    its chip noise or None (the noise model acts where there is one);
    ``quant`` with ``phase_bits`` snaps the commanded phases first.
    Returns ``(S, out_dim, in_dim)`` per matrix, contiguous: the memory of
    its TT core ``(S, r, m, n, r')``.  The meshes run through this
    module's ``mesh_apply_stacked``, so on any device this is plain
    PyTorch."""
    cores = []
    for pm, p, nz in zip(matrices, params, noises, strict=True):
        eye = torch.eye(pm.in_dim, dtype=torch.float32,
                        device=p["sigma"].device)
        y = pm._apply(p, eye, noise_model, nz, quant, mesh_apply_stacked)
        cores.append(y.transpose(-1, -2).contiguous())
    return cores


def mzi_count_matrix(out_dim: int, in_dim: int) -> int:
    """MZIs of an SVD-implemented (out × in) matrix: two square meshes."""
    return out_dim * (out_dim - 1) // 2 + in_dim * (in_dim - 1) // 2
