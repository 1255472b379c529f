"""The paper's 3-layer sine MLP bound to a PDE problem, and its BP-free losses.

``TensorPinn`` (in → n → n → 1, sine activations) in the paper's four
parametrizations:

  * ``dense`` — plain weight matrices (the uncompressed off-chip baseline),
  * ``onn``  — every weight of the first two layers an SVD pair of full
               MZI meshes (the paper's ONN baseline, ``ONN_ONCHIP``): the
               meshes run on the activations, with the chip's noise, in
               every forward (``PhotonicMatrix.apply`` / ``apply_stacked``
               → ``kernels.ops.mesh_apply[_stacked]``; on the card the
               wide routes of the mesh kernel take the hidden-width
               meshes: warp rows at small batches, a dense tensor-core
               product at large ones),
  * ``tt``   — first two layers TT-compressed (digital TT baseline),
  * ``tonn`` — TT-cores whose unfoldings are MZI meshes, the paper's
               proposed hardware; the meshes are densified into plain
               TT-cores with the chip's noise baked in, once per loss
               evaluation (training) or once at load (serving), in one
               grouped launch (``kernels.ops.mesh_densify_stacked``);
               ``prepare_params_plain`` is the differentiable plain
               densification the tests hold it against.

Serving runs the single forward, whose TT layers go through
``kernels.ops.tt_linear``, and so does sequential ZO training, one model
at a time; the off-chip BP baselines differentiate that forward with
autograd (on the card, ``tt_linear`` runs the TT kernel and its
hand-written backward, tonn's grouped densification its grouped backward,
and onn's meshes the backward of their forward's route: the resident
backward up to ~138 ports; at hidden 1024 the warp-rows backward where
route A ran (layer 0's U mesh on the batch and the identity columns) and
the dense backward where route B did (the hidden layer's meshes on the
stencil's rows: two tensor-core products and a walk on the mesh's own
rows); a width whose meshes no backward holds, ``onn_no_backward_ports``,
is ROADMAP item 6c-3).  ``dense`` layers are
``torch.matmul`` / ``einsum``, as the JAX package leaves them to XLA.
Fused ZO training runs the stacked path: the N+1 SPSA-perturbed
parameter sets of every core mesh densify in one program
(``prepare_params_stacked`` → ``kernels.ops.mesh_densify_stacked``, one
launch) and the FD stencil goes through every perturbed model at once
(``fd_u_stencil_stacked`` → ``kernels.ops.tt_linear_batched``, three
launches).  On the card those are the CUDA kernels; on the CPU their
plain versions.  Forwards are plain functions of a params dict of
tensors.

Quantization-aware training and serving (``cfg.quant``): with weight
quantization on, every TT layer sees block-scaled int8 / fp8 cores (the
``quant=`` hooks of ``kernels.ops``; the stacked path runs the
``tt_contract_batched_quant`` kernel on the card), and with ``phase_bits``
set the mesh densification snaps the commanded phases to the DAC grid
before the noise model.  ZO training is gradient-free, so fake-quant in the
loss is the whole of QAT.  With ``cfg.quant`` disabled every path is the
unquantized one, bit for bit.

Derivatives come from the FD stencil (``fd``, ``fd_fast``), the
Gaussian-smoothing Stein estimator (``stein``: 2S+1 stacked inferences at
random directions, from an explicit ``generator`` or handed in as ``z``;
the stacked Stein path gives every entry of the stack its own directions,
so its layer-0 launch reads per-entry rows) or the spectral one
(``spectral``: u on per-axis line grids through each anchor,
differentiated by FFT, ``core.spectral``; the stacked path puts the shared
line rows through every perturbed model at once, two
``tt_linear_batched`` launches, then FFTs each entry's lines).  ``auto``
takes the problem's own estimator.  A problem with an input feature map
(ns-2d's Fourier features) replaces the row with its features before the
padding, and takes plain ``fd`` where ``fd_fast`` is asked for.  A
coefficient-conditioned problem's rows carry its coefficients after the
point: ``_embed`` normalizes them, no estimator shifts them, and
``u_coeff_grid[_stacked]`` evaluates one batch of points under C
coefficient vectors in one forward.

Port of ``repro.core.pinn``.  Two paths of the JAX
package are CPU-XLA workarounds with no counterpart here: the polynomial
``fast_sin`` (the port takes ``torch.sin``) and the Kronecker head of
``_f_head_stacked`` (the port takes the TT chain, as the JAX package does
on a TPU).  With them goes the unfused chain, and so ``_fq_cores``, its
fake-quant: every TT layer of the port goes through ``kernels.ops``, which
quantizes through its own ``quant=`` hook.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import pde as pde_lib
from repro_torch.core import photonic, spectral, stein, tt
from repro_torch.kernels import mesh_apply as mesh_kernels
from repro_torch.kernels import ops
from repro_torch.kernels import quant as quant_lib

__all__ = ["PINNConfig", "TensorPinn", "config_to_meta", "config_from_meta",
           "residual_loss", "residual_losses_stacked", "per_term_losses",
           "validation_mse", "onn_no_backward_ports"]

PORTED_MODES = ("dense", "onn", "tt", "tonn")


@dataclasses.dataclass(frozen=True)
class PINNConfig:
    """Every field of ``repro.core.pinn.PINNConfig``, so checkpoint meta
    round-trips.  The port reads ``hidden``, ``mode``, ``tt_rank``,
    ``tt_L``, ``pde``, ``noise``, ``quant``, ``fd_step``, ``deriv``,
    ``stein_sigma``, ``stein_samples`` and ``spectral_points`` (None: the
    problem's).
    ``use_fused_kernel`` picks nothing here: the TT layers always go
    through ``kernels.ops``."""

    space_dim: int = 20
    hidden: int = 1024
    mode: str = "tonn"          # dense | onn | tt | tonn
    tt_rank: int = 2            # paper: ranks [1,2,1,2,1]
    tt_L: int = 4               # paper: 1024 = [4,8,4,8] · [8,4,8,4]
    fd_step: float | None = None  # None → the problem's recommended step
    deriv: str = "fd"           # fd | fd_fast | stein | spectral | auto
    stein_sigma: float = 5e-2
    stein_samples: int = 32
    spectral_points: int | None = None
    use_fused_kernel: bool = False
    pde: str = "hjb-20d"
    noise: photonic.NoiseModel = dataclasses.field(
        default_factory=lambda: photonic.NoiseModel(enabled=False))
    quant: quant_lib.QuantConfig = dataclasses.field(
        default_factory=lambda: quant_lib.QuantConfig(enabled=False))


def config_to_meta(cfg: PINNConfig) -> dict:
    """JSON-safe dict of a ``PINNConfig`` — the checkpoint-meta form."""
    return dataclasses.asdict(cfg)


def config_from_meta(meta: dict) -> PINNConfig:
    """Inverse of ``config_to_meta``.  Unknown keys are ignored (configs
    written by a newer version still load); missing keys take defaults.
    The quant settings are validated (``QuantConfig`` raises on an unknown
    dtype, a block below 1 or phase bits outside [1, 32])."""
    fields = {f.name for f in dataclasses.fields(PINNConfig)}
    kw = {k: v for k, v in meta.items() if k in fields}
    for key, cls in (("noise", photonic.NoiseModel),
                     ("quant", quant_lib.QuantConfig)):
        if isinstance(kw.get(key), dict):
            sub = {f.name for f in dataclasses.fields(cls)}
            kw[key] = cls(**{k: v for k, v in kw[key].items() if k in sub})
    return PINNConfig(**kw)


def onn_no_backward_ports(cfg: PINNConfig) -> list:
    """The widths of ``cfg``'s ``onn`` meshes (rectangular layouts) that no
    backward kernel holds (``kernels.mesh_apply.grad_design``: past 1024
    ports, the owner walk's): BP through them is ROADMAP item 6c-3.  The
    same on every device; empty for the other modes."""
    if cfg.mode != "onn":
        return []
    net = pde_lib.get_problem(cfg.pde).feature_dim
    return sorted({p for p in (cfg.hidden, net)
                   if mesh_kernels.grad_design(
                       photonic.rectangular_layout(p)) is None})


class TensorPinn:
    """The paper's 3-layer sine MLP in a TT parametrization, solving a
    registered PDE problem (``cfg.pde`` or an explicit instance)."""

    def __init__(self, cfg: PINNConfig,
                 problem: pde_lib.PDEProblem | None = None):
        if cfg.mode not in PORTED_MODES:
            raise ValueError(f"unknown mode {cfg.mode!r}; the port has "
                             f"{PORTED_MODES}")
        self.cfg = cfg
        self.problem = problem if problem is not None \
            else pde_lib.get_problem(cfg.pde)
        self.space_dim = self.problem.space_dim
        self.in_dim = self.problem.in_dim
        self.net_in = self.problem.net_dim
        # the width the network takes: a feature map (``embed_features``)
        # replaces the row, and its output is what gets padded
        self.feat_in = self.problem.feature_dim
        # an explicit config value wins; None takes the problem's step
        self.fd_step = (cfg.fd_step if cfg.fd_step is not None
                        else self.problem.fd_step)
        # the quant hooks take None when quantization is off, so every
        # consumer keeps its unquantized path
        self._quant = cfg.quant if cfg.quant.enabled else None
        h = cfg.hidden
        self.in_pad, self.specs = self.feat_in, []
        if cfg.mode in ("tt", "tonn"):
            # pad the input up to a TT-factorizable width (the paper folds
            # 21 → 1024 so layer 1 is a 1024×1024 TT matrix)
            self.in_pad = (h if h >= self.feat_in
                           else -(-self.feat_in // 8) * 8)
            self.specs = [
                tt.hjb_layer_spec(h, self.in_pad, L=cfg.tt_L,
                                  max_rank=cfg.tt_rank),
                tt.hjb_layer_spec(h, h, L=cfg.tt_L, max_rank=cfg.tt_rank),
            ]
        self.dims = [(h, self.in_pad), (h, h), (1, h)]
        if cfg.mode == "onn":
            # the input is not padded: layer 0 is a (hidden × feat_in) SVD
            # pair of meshes
            self.photonic = [photonic.PhotonicMatrix(m, n)
                             for (m, n) in self.dims[:2]]
        if cfg.mode == "tonn":
            # each TT-core's (r·m × n·r') unfolding is an MZI-mesh matrix
            self.photonic_cores = [
                [photonic.PhotonicMatrix(r * m, n * rn)
                 for (r, m, n, rn) in spec.core_shapes]
                for spec in self.specs
            ]

    @property
    def uses_noise(self) -> bool:
        """True when the forward consumes per-chip hardware noise."""
        return self.cfg.noise.enabled and self.cfg.mode in ("onn", "tonn")

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> dict:
        """Random params, drawn on the CPU from ``generator`` (the same
        weights for a seed on every device); the caller moves them."""
        cfg = self.cfg
        params: dict = {}
        if cfg.mode == "dense":
            for i, (m, n) in enumerate(self.dims):
                params[f"w{i}"] = (math.sqrt(2.0 / (m + n))
                                   * torch.randn((m, n), generator=generator))
                params[f"b{i}"] = torch.zeros((m,))
            return params
        if cfg.mode == "onn":
            for i, pm in enumerate(self.photonic):
                params[f"p{i}"] = pm.init(generator)
                params[f"b{i}"] = torch.zeros((self.dims[i][0],))
        for i, spec in enumerate(self.specs):
            if cfg.mode == "tt":
                params[f"cores{i}"] = tt.tt_init(generator, spec)
            else:
                # scale each core mesh so the dense product has glorot var
                n_paths = float(math.prod(spec.ranks[1:-1])) if spec.L > 1 else 1.0
                tgt = 2.0 / (spec.in_dim + spec.out_dim)
                per_core = (tgt / n_paths) ** (1.0 / spec.L)
                params[f"pcores{i}"] = [
                    pm.init(generator, scale=math.sqrt(per_core))
                    for pm in self.photonic_cores[i]]
            params[f"b{i}"] = torch.zeros((self.dims[i][0],))
        params["w2"] = (math.sqrt(2.0 / (1 + cfg.hidden))
                        * torch.randn((1, cfg.hidden), generator=generator))
        params["b2"] = torch.zeros((1,))
        return params

    def trainable_mask(self, params: dict) -> dict:
        """Boolean tree mirroring ``params``: False on the fixed ±1
        ``diag_u``/``diag_v`` buffers of every ``PhotonicMatrix``
        (``photonic.PHOTONIC_BUFFER_KEYS``), which ZO training must
        neither perturb nor update, True on every other leaf."""
        def mask(node, trainable):
            if isinstance(node, dict):
                return {k: mask(v, trainable
                                and k not in photonic.PHOTONIC_BUFFER_KEYS)
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [mask(v, trainable) for v in node]
            return trainable

        return mask(params, True)

    def sample_noise(self, generator: torch.Generator) -> dict | None:
        """One chip's fabrication noise (fixed for the chip's lifetime),
        drawn on the CPU, or None when the forward uses none."""
        if not self.uses_noise:
            return None
        if self.cfg.mode == "onn":
            return {f"p{i}": pm.sample_noise(generator, self.cfg.noise)
                    for i, pm in enumerate(self.photonic)}
        return {f"pcores{i}": [pm.sample_noise(generator, self.cfg.noise)
                               for pm in pms]
                for i, pms in enumerate(self.photonic_cores)}

    # --------------------------------------------------------------- forward
    def _pcore_args(self, pcores: dict, noise: dict | None) -> tuple:
        """The arguments of ``mesh_densify_stacked`` for every core matrix
        of both layers: matrices, their stacked params, their noise."""
        layers = range(len(self.specs))
        pms = [pm for i in layers for pm in self.photonic_cores[i]]
        nzs = ([None] * len(pms) if noise is None
               else [nz for i in layers for nz in noise[f"pcores{i}"]])
        return pms, [p for i in layers for p in pcores[f"pcores{i}"]], nzs

    def _cores_of(self, dense) -> dict:
        """``cores{i}`` from the densified matrices, in order."""
        dense = iter(dense)
        return {f"cores{i}": [next(dense).view(-1, *shape)
                              for shape in self.specs[i].core_shapes]
                for i in range(len(self.specs))}

    def prepare_params(self, params: dict, noise: dict | None) -> tuple:
        """Densify TONN meshes into plain TT-cores once, noise baked in:
        ``prepare_params_stacked`` over a stack of one, one grouped call.
        On the card that is one ``mesh_densify_stacked`` launch and, where
        autograd differentiates it (the BP baselines' step), one launch of
        its backward ``mesh_densify_grad`` (``mesh_apply.MeshDensifyFn``);
        on the CPU the plain grouped densification, which autograd
        differentiates natively.

        Returns ``(effective_params, effective_noise)``; a no-op for the
        other modes and for already-prepared dicts."""
        if self.cfg.mode != "tonn" or "cores0" in params:
            return params, noise
        one = {k: [{n: t[None] for n, t in p.items()} for p in v]
               for k, v in params.items() if k.startswith("pcores")}
        eff = {k: v for k, v in params.items() if not k.startswith("pcores")}
        dense = ops.mesh_densify_stacked(*self._pcore_args(one, noise),
                                         self.cfg.noise, self._quant)
        for name, cores in self._cores_of(dense).items():
            eff[name] = [c[0] for c in cores]
        return eff, None

    def prepare_params_plain(self, params: dict, noise: dict | None) -> tuple:
        """``prepare_params`` through the plain gather form on any device
        (``PhotonicMatrix.to_dense`` per core matrix), which autograd
        differentiates: the plain oracle that the tests and
        ``chip_smoke.py`` hold the grouped kernels and their backward
        against.  Nothing on the main path calls it.  DAC phase
        quantization acts on the commanded phases, before the noise
        model."""
        if self.cfg.mode != "tonn" or "cores0" in params:
            return params, noise
        eff = {k: v for k, v in params.items() if not k.startswith("pcores")}
        for i, spec in enumerate(self.specs):
            eff[f"cores{i}"] = []
            for k, pm in enumerate(self.photonic_cores[i]):
                nz = None if noise is None else noise[f"pcores{i}"][k]
                w = pm.to_dense(params[f"pcores{i}"][k],
                                self.cfg.noise if nz else None, nz,
                                quant=self._quant)
                eff[f"cores{i}"].append(
                    w.reshape(spec.core_shapes[k]).contiguous())
        return eff, None

    def _layer_matvec(self, params: dict, noise: dict | None, i: int,
                      x: torch.Tensor) -> torch.Tensor:
        if self.cfg.mode == "dense":
            return x @ params[f"w{i}"].T
        if self.cfg.mode == "onn":
            nz = None if noise is None else noise[f"p{i}"]
            return self.photonic[i].apply(params[f"p{i}"], x,
                                          self.cfg.noise if nz else None,
                                          nz, quant=self._quant)
        return ops.tt_linear(x, params[f"cores{i}"], self.specs[i],
                             quant=self._quant)

    def _embed(self, xt: torch.Tensor) -> torch.Tensor:
        """Rows (..., net_in) → network inputs (..., in_pad): the problem's
        feature map where it has one; else the coefficient slots of a
        conditioned problem normalized to [0, 1] by its ``CoeffSpec``
        (the physical coordinates pass as they are, so the embedding stays
        affine per slot and ``fd_fast``'s rank-1 columns hold); then
        zero-padded."""
        if self.problem.has_feature_map:
            xt = self.problem.embed_features(xt)
        elif self.problem.coeff_spec is not None:
            xt = torch.cat([xt[..., :self.in_dim],
                            self.problem.coeff_spec.normalize(
                                xt[..., self.in_dim:self.net_in])], dim=-1)
        return torch.nn.functional.pad(xt, (0, self.in_pad - self.feat_in))

    def f(self, params: dict, xt: torch.Tensor,
          noise: dict | None = None) -> torch.Tensor:
        """Base network f(xt): (B, net_in) → (B,)."""
        params, noise = self.prepare_params(params, noise)
        h = self._embed(xt)
        for i in range(2):
            h = torch.sin(self._layer_matvec(params, noise, i, h)
                          + params[f"b{i}"])
        out = h @ params["w2"].T + params["b2"]
        return out[..., 0]

    def u(self, params: dict, xt: torch.Tensor,
          noise: dict | None = None) -> torch.Tensor:
        """Problem ansatz u = T(f, xt)."""
        return self.problem.ansatz(self.f(params, xt, noise), xt)

    # ------------------------------------------------- incremental FD stencil
    def _identity_columns(self, like: torch.Tensor) -> torch.Tensor:
        """The first ``in_dim`` unit vectors of the padded input,
        (in_dim, in_pad), in ``like``'s dtype and on its device."""
        return torch.eye(self.in_dim, self.in_pad, dtype=like.dtype,
                         device=like.device)

    def _layer1_columns(self, params: dict, noise: dict | None) -> torch.Tensor:
        """Columns 0..in_dim of the first-layer matrix, (in_dim, hidden):
        the FD stencil only shifts the input by ±h·e_i, and layer 1 is
        linear, so one extraction replaces 2·in_dim layer-1 matvecs."""
        return self._layer_matvec(params, noise, 0,
                                  self._identity_columns(params["b0"]))

    @staticmethod
    def _stencil_activations(z0: torch.Tensor, cols: torch.Tensor,
                             h: float) -> torch.Tensor:
        """Layer-1 activations over the FD stencil.  Layer 1 is linear, so
        the pre-activation at x ± h·e_i is ``z0 ± h·cols[i]``: from
        ``z0 (..., B, H)`` and ``cols (..., A, H)`` this gives
        ``(..., 2A+1, B, H)`` in the order of ``fd_stencil_points``."""
        z0 = z0[..., None, :, :]
        hcols = (h * cols)[..., :, None, :]
        return torch.sin(torch.cat([z0, z0 + hcols, z0 - hcols], dim=-3))

    def fd_u_stencil(self, params: dict, xt: torch.Tensor, h: float,
                     noise: dict | None = None) -> torch.Tensor:
        """u at [x, x+h·e_1, ..., x−h·e_A]: (2·in_dim+1, B) values with
        layer 1 computed once (incremental rank-1 FD forward)."""
        params, noise = self.prepare_params(params, noise)
        B, A = xt.shape[0], self.in_dim
        z0 = self._layer_matvec(params, noise, 0, self._embed(xt)) \
            + params["b0"]                                           # (B, H)
        a = self._stencil_activations(
            z0, self._layer1_columns(params, noise), h)
        a = torch.sin(self._layer_matvec(params, noise, 1,
                                         a.reshape(-1, self.cfg.hidden))
                      + params["b1"])
        f = (a @ params["w2"].T + params["b2"])[..., 0].reshape(2 * A + 1, B)
        return self.problem.ansatz(f, pde_lib.fd_stencil_points(xt, h, A))

    # --------------------------------------- stacked (multi-perturbation) ZO
    def prepare_params_stacked(self, stacked: dict, noise: dict | None) -> dict:
        """``prepare_params`` over a leading perturbation axis P on every
        leaf: all P phase sets of every TONN core mesh of both layers
        densify in one program (``kernels.ops.mesh_densify_stacked``), with
        the chip's noise shared across the stack."""
        if self.cfg.mode != "tonn" or "cores0" in stacked:
            return stacked
        dense = ops.mesh_densify_stacked(*self._pcore_args(stacked, noise),
                                         self.cfg.noise, self._quant)
        eff = {k: v for k, v in stacked.items() if not k.startswith("pcores")}
        eff.update(self._cores_of(dense))
        return eff

    def _layer_matvec_stacked(self, stacked: dict, i: int, x: torch.Tensor,
                              noise: dict | None = None) -> torch.Tensor:
        """Layer-i matvec of P stacked (prepared) parameter sets: x
        ``(B', n)`` shared or ``(P, B', n)`` per entry → ``(P, B', m)``.
        ``noise`` (one chip's, shared across the stack) is read in ``onn``
        mode only: ``tonn`` bakes it into the densified cores."""
        if self.cfg.mode == "dense":
            sub = "bn,pmn->pbm" if x.ndim == 2 else "pbn,pmn->pbm"
            return torch.einsum(sub, x, stacked[f"w{i}"])
        if self.cfg.mode == "onn":
            nz = None if noise is None else noise[f"p{i}"]
            return self.photonic[i].apply_stacked(
                stacked[f"p{i}"], x, self.cfg.noise if nz else None, nz,
                quant=self._quant)
        return ops.tt_linear_batched(x, stacked[f"cores{i}"], self.specs[i],
                                     quant=self._quant)

    def _f_head_stacked(self, stacked: dict, a: torch.Tensor,
                        noise: dict | None = None) -> torch.Tensor:
        """``f = sin(W1·a + b1) @ w2ᵀ + b2`` for P stacked parameter sets:
        (P, B', hidden) activations → (P, B') f-values.

        The head's dot products are a plain reduction over each row's
        products: a row's f keeps its bits whatever P and B' are, which a
        batched GEMV does not promise (on the card cuBLAS picks its kernel
        by shape, and the FD residual turns that last bit into per-cent
        losses).  So a rank of distributed ZO, which evaluates a slice of
        the stack on a shard of the batch, computes each loss's rows as the
        whole stack does."""
        z = self._layer_matvec_stacked(stacked, 1, a, noise) \
            + stacked["b1"][:, None]
        return (torch.sin(z) * stacked["w2"]).sum(-1) + stacked["b2"]

    def fd_u_stencil_stacked(self, stacked: dict, xt: torch.Tensor, h: float,
                             noise: dict | None = None) -> torch.Tensor:
        """``fd_u_stencil`` for P stacked (prepared) parameter sets:
        (P, 2·in_dim+1, B) u-values.  The collocation rows and the
        identity columns are shared across the stack, so layer 1 reads
        them once per (entry, row tile); the hidden layer reads each
        entry's own (2A+1)·B activations, one contiguous block.  ``noise``
        as in ``_layer_matvec_stacked``."""
        B, A = xt.shape[0], self.in_dim
        P = stacked["b0"].shape[0]
        z0 = self._layer_matvec_stacked(stacked, 0, self._embed(xt), noise) \
            + stacked["b0"][:, None]                               # (P, B, H)
        cols = self._layer_matvec_stacked(
            stacked, 0, self._identity_columns(xt), noise)         # (P, A, H)
        a = self._stencil_activations(z0, cols, h).reshape(
            P, (2 * A + 1) * B, self.cfg.hidden)
        f = self._f_head_stacked(stacked, a, noise).reshape(P, 2 * A + 1, B)
        return self.problem.ansatz(f, pde_lib.fd_stencil_points(xt, h, A))

    def stein_u_stacked(self, stacked: dict, xt: torch.Tensor,
                        z: torch.Tensor, sigma: float,
                        noise: dict | None = None) -> torch.Tensor:
        """u at every entry's own Stein stencil for P stacked (prepared)
        parameter sets: rows xt (B, net_in) and directions z (P, S, B,
        net_in) → (P, 2S+1, B).  One stacked forward over per-entry rows
        (``tt`` / ``tonn``: two ``tt_linear_batched`` launches, both per
        entry).  ``noise`` as in ``_layer_matvec_stacked``."""
        P, S, B = z.shape[:3]
        pts = stein.stein_stencil_points(xt, z, sigma)
        u = self.u_stacked(stacked, pts.reshape(P, (2 * S + 1) * B, -1),
                           noise)
        return u.reshape(P, 2 * S + 1, B)

    def f_stacked(self, stacked: dict, xt: torch.Tensor,
                  noise: dict | None = None) -> torch.Tensor:
        """Base network of P stacked (prepared) parameter sets over a
        shared batch (B, net_in) → (P, B), or over per-entry rows
        (P, B, net_in) → (P, B)."""
        a = torch.sin(self._layer_matvec_stacked(stacked, 0, self._embed(xt),
                                                 noise)
                      + stacked["b0"][:, None])
        return self._f_head_stacked(stacked, a, noise)

    def u_stacked(self, stacked: dict, xt: torch.Tensor,
                  noise: dict | None = None) -> torch.Tensor:
        """Ansatz u of P stacked parameter sets: (B, net_in) shared or
        (P, B, net_in) per entry → (P, B)."""
        return self.problem.ansatz(self.f_stacked(stacked, xt, noise), xt)

    # ------------------------------------------- coefficient-family queries
    def _coeff_rows(self, pts: torch.Tensor, coeffs) -> torch.Tensor:
        """(B, in_dim) physical points × (C, K) raw coefficient vectors →
        (C·B, net_in) augmented rows, C-major."""
        if self.problem.coeff_spec is None:
            raise ValueError(
                f"PDE {self.problem.name!r} is not coefficient-conditioned")
        coeffs = torch.as_tensor(coeffs, dtype=pts.dtype, device=pts.device)
        (C, K), B = coeffs.shape, pts.shape[0]
        rows = torch.cat([pts[None].expand(C, B, self.in_dim),
                          coeffs[:, None, :].expand(C, B, K)], dim=-1)
        return rows.reshape(C * B, self.net_in)

    def u_coeff_grid(self, params: dict, pts: torch.Tensor, coeffs,
                     noise: dict | None = None) -> torch.Tensor:
        """u over the coefficient × point grid, (C, B): one physical batch
        under C scenarios through one forward over the flattened rows."""
        C, B = len(coeffs), pts.shape[0]
        return self.u(params, self._coeff_rows(pts, coeffs),
                      noise).reshape(C, B)

    def u_coeff_grid_stacked(self, stacked: dict, pts: torch.Tensor, coeffs,
                             noise: dict | None = None) -> torch.Tensor:
        """``u_coeff_grid`` for P stacked (prepared) parameter sets, (P, C,
        B): the perturbations × coefficients double batch, flattened
        through the stacked forward (``noise`` as in
        ``_layer_matvec_stacked``)."""
        C, B = len(coeffs), pts.shape[0]
        vals = self.u_stacked(stacked, self._coeff_rows(pts, coeffs), noise)
        return vals.reshape(vals.shape[0], C, B)


# ---------------------------------------------------------------------- loss

def _loss_from_u_stencil(problem: pde_lib.PDEProblem, vals: torch.Tensor,
                         h: float, xt: torch.Tensor) -> torch.Tensor:
    """Residual loss from u-values at the central-difference stencil:
    vals (..., 2·Din+1, B) → mean-squared residual (...,)."""
    est = problem.scale_estimate(pde_lib.estimate_from_u_stencil(vals, h))
    r = problem.residual(est, xt)
    return torch.mean(r * r, dim=-1)


def _boundary_mse(u_b: torch.Tensor, ub_target: torch.Tensor) -> torch.Tensor:
    """Mean-squared target mismatch over the trailing (batch) axis."""
    return torch.mean((u_b - ub_target) ** 2, dim=-1)


def _term_plan(problem: pde_lib.PDEProblem,
               term_batches: dict | None) -> tuple:
    """``(collocation_weight, [(LossTerm, (x, target)), ...])`` from
    ``term_batches`` keyed by term name: missing or None entries are
    skipped, unknown names raise.  (The JAX package's deprecated
    ``bc=(xb, ub)`` convention is not ported.)"""
    terms = problem.loss_terms()
    coll_w = next((t.weight for t in terms if t.kind == "collocation"), 1.0)
    if not term_batches:
        return coll_w, []
    known = {t.name: t for t in terms if t.kind != "collocation"}
    unknown = sorted(set(term_batches) - set(known))
    if unknown:
        raise ValueError(
            f"unknown loss term(s) {unknown} for PDE {problem.name!r}; "
            f"known non-collocation terms: {sorted(known)}")
    return coll_w, [(known[name], batch)
                    for name, batch in term_batches.items()
                    if batch is not None]


def _resolve_deriv(cfg: PINNConfig, problem: pde_lib.PDEProblem) -> str:
    """``cfg.deriv``, "auto" deferring to the problem's ``estimator``.
    ``fd_fast``'s rank-1 stencil needs an affine embedding, which a feature
    map breaks: such a problem takes plain ``fd`` (the same estimate, more
    layer-1 rows)."""
    deriv = problem.estimator if cfg.deriv == "auto" else cfg.deriv
    if deriv == "fd_fast" and problem.has_feature_map:
        return "fd"
    if deriv in ("fd", "fd_fast", "stein", "spectral"):
        return deriv
    raise ValueError(f"unknown derivative estimator {deriv!r}")


def _spectral_grid(model: TensorPinn) -> tuple:
    """(M, extent, periodization) of the model's problem: M from the
    config when set, the domain's facts always from the problem."""
    problem = model.problem
    M = model.cfg.spectral_points or problem.spectral_points
    return M, problem.spectral_extent, problem.spectral_periodization


def _spectral_rows(model: TensorPinn, xt: torch.Tensor) -> torch.Tensor:
    """The deduped line rows through the anchors ``xt``."""
    M, extent, _ = _spectral_grid(model)
    return spectral.spectral_line_rows(xt, model.in_dim, M, extent)


def _spectral_loss(model: TensorPinn, vals: torch.Tensor,
                   rows: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """Residual loss from u over the line rows: vals (..., R) → the mean
    squared residual over the anchors, (...,) (leading axes: the stack)."""
    problem = model.problem
    M, extent, periodization = _spectral_grid(model)
    est = spectral.estimate_from_line_vals(
        vals, xt, model.in_dim, M, extent, periodization,
        carrier=problem.spectral_carrier(rows, xt))
    r = problem.residual(problem.scale_estimate(est), xt)
    return torch.mean(r * r, dim=-1)


def _add_terms(loss: torch.Tensor, problem: pde_lib.PDEProblem,
               term_batches, u_fn) -> torch.Tensor:
    """The collocation loss weighted, plus ``weight · MSE`` of every
    boundary/data term with a batch (``u_fn(x)`` evaluates u)."""
    coll_w, plan = _term_plan(problem, term_batches)
    if coll_w != 1.0:
        loss = coll_w * loss
    for t, (xb, ub) in plan:
        loss = loss + t.weight * _boundary_mse(u_fn(xb), ub)
    return loss


def residual_loss(model: TensorPinn, params: dict, xt: torch.Tensor,
                  noise: dict | None = None,
                  term_batches: dict | None = None,
                  generator: torch.Generator | None = None,
                  z: torch.Tensor | None = None) -> torch.Tensor:
    """BP-free composite PDE loss of one parameter set: the collocation
    residual over ``xt`` from FD derivatives (``fd_fast``: layer 1 once),
    Stein's (``cfg.stein_samples`` directions drawn from ``generator``, or
    ``z`` (S, B, D) as given) or spectral ones (u on the line rows through
    the anchors ``xt``, one forward) plus ``weight · MSE(u(x), target)``
    per supplied boundary/data term."""
    problem = model.problem
    deriv = _resolve_deriv(model.cfg, problem)
    params, noise = model.prepare_params(params, noise)
    h = model.fd_step
    if deriv == "spectral":
        rows = _spectral_rows(model, xt)
        loss = _spectral_loss(model, model.u(params, rows, noise), rows, xt)
    elif deriv == "fd_fast":
        vals = model.fd_u_stencil(params, xt, h, noise)
        loss = _loss_from_u_stencil(problem, vals, h, xt)
    elif deriv == "stein":
        cfg = model.cfg
        est = stein.stein_estimate(lambda pts: model.u(params, pts, noise),
                                   xt, generator, sigma=cfg.stein_sigma,
                                   num_samples=cfg.stein_samples,
                                   n_active=model.in_dim, z=z)
        r = problem.residual(problem.scale_estimate(est), xt)
        loss = torch.mean(r * r)
    else:
        est = stein.fd_estimate(lambda pts: model.u(params, pts, noise), xt,
                                h=h, n_active=model.in_dim)
        r = problem.residual(problem.scale_estimate(est), xt)
        loss = torch.mean(r * r)
    return _add_terms(loss, problem, term_batches,
                      lambda xb: model.u(params, xb, noise))


def residual_losses_stacked(model: TensorPinn, stacked_params: dict,
                            xt: torch.Tensor, noise: dict | None = None,
                            term_batches: dict | None = None,
                            generator: torch.Generator | None = None,
                            z: torch.Tensor | None = None) -> torch.Tensor:
    """The ZO hot path: composite losses of P stacked parameter sets
    (leading axis on every leaf) over one shared collocation batch → (P,).

    TONN densifies all P mesh sets of every core mesh in one program (the
    chip's noise baked in); then the FD stencil goes through every
    perturbed model in one program — with ``fd_fast``, three
    ``tt_linear_batched`` launches (layer 1 on the rows and on the
    identity columns, the hidden layer on the stencil's activations), or
    in ``onn`` mode six stacked meshes, which apply the chip's noise.

    With ``stein`` every entry draws its own directions, ``z`` (P, S, B,
    D) as given or drawn from ``generator``: entry i equals
    ``residual_loss(model, params_i, xt, noise, z=z[i])``, so identical
    stacked params still see distinct noise (the reference splits its key
    per entry).  It stays one stacked program: each entry's (2S+1)·B rows
    go through its own model, two per-entry ``tt_linear_batched``
    launches.

    With ``spectral`` the B·(A·(M−1)+1) line rows are shared by the stack:
    one stacked forward (two ``tt_linear_batched`` launches, layer 0 on
    the shared rows), then each entry's lines go through the FFT."""
    problem = model.problem
    deriv = _resolve_deriv(model.cfg, problem)
    prepared = model.prepare_params_stacked(stacked_params, noise)
    eff_noise = noise if model.cfg.mode == "onn" else None
    h = model.fd_step
    if deriv == "spectral":
        rows = _spectral_rows(model, xt)
        losses = _spectral_loss(model,
                                model.u_stacked(prepared, rows, eff_noise),
                                rows, xt)
    elif deriv == "stein":
        P = prepared["b0"].shape[0]
        z = stein.stein_directions(xt, generator, model.cfg.stein_samples,
                                   model.in_dim, z, lead=(P,))
        sigma = model.cfg.stein_sigma
        vals = model.stein_u_stacked(prepared, xt, z, sigma, eff_noise)
        est = stein.estimate_from_stein_vals(vals, z, sigma, model.in_dim)
        r = problem.residual(problem.scale_estimate(est), xt)
        losses = torch.mean(r * r, dim=-1)
    elif deriv == "fd_fast":
        vals = model.fd_u_stencil_stacked(prepared, xt, h, eff_noise)
        losses = _loss_from_u_stencil(problem, vals, h, xt)
    else:
        (B, D), A = xt.shape, model.in_dim
        pts = pde_lib.fd_stencil_points(xt, h, A)
        vals = model.u_stacked(prepared, pts.reshape(-1, D), eff_noise)
        vals = vals.reshape(vals.shape[0], 2 * A + 1, B)
        losses = _loss_from_u_stencil(problem, vals, h, xt)
    return _add_terms(losses, problem, term_batches,
                      lambda xb: model.u_stacked(prepared, xb, eff_noise))


def per_term_losses(model: TensorPinn, params: dict, xt: torch.Tensor,
                    noise: dict | None = None,
                    term_batches: dict | None = None,
                    generator: torch.Generator | None = None,
                    z: torch.Tensor | None = None) -> dict:
    """Unweighted per-term losses keyed by term name (terms whose batch is
    absent are omitted); ``generator`` / ``z`` as in ``residual_loss``.
    tonn densifies its meshes once for all the terms."""
    params, noise = model.prepare_params(params, noise)
    out = {}
    for t in model.problem.loss_terms():
        if t.kind == "collocation":
            out[t.name] = residual_loss(model, params, xt, noise,
                                        generator=generator, z=z)
        elif (term_batches or {}).get(t.name) is not None:
            xb, ub = term_batches[t.name]
            out[t.name] = _boundary_mse(model.u(params, xb, noise), ub)
    return out


def validation_mse(model: TensorPinn, params: dict, xt: torch.Tensor,
                   noise: dict | None = None) -> torch.Tensor:
    """MSE against the problem's closed-form solution (raises without one)."""
    exact = model.problem.exact_solution(xt)
    if exact is None:
        raise ValueError(f"PDE {model.problem.name!r} has no exact solution; "
                         "track the residual loss instead")
    return torch.mean((model.u(params, xt, noise) - exact) ** 2)
