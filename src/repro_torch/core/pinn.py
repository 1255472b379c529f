"""The paper's 3-layer sine MLP bound to a PDE problem — serving slice.

``TensorPinn`` (in → n → n → 1, sine activations) in two of the paper's
parametrizations:

  * ``tt``   — first two layers TT-compressed (digital TT baseline),
  * ``tonn`` — TT-cores whose unfoldings are MZI meshes, the paper's
               proposed hardware; ``prepare_params`` densifies the meshes
               into plain TT-cores once, with the chip's noise baked in.

Both TT layers go through ``kernels.ops.tt_linear``: the CUDA kernel on
the card, its plain version on the CPU.  Forwards are plain functions of a
params dict of tensors.  Port of ``repro.core.pinn``; the ``dense`` and
``onn`` modes, the FD stencils and the losses belong to later slices.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import pde as pde_lib
from repro_torch.core import photonic, tt
from repro_torch.kernels import ops
from repro_torch.kernels import quant as quant_lib

__all__ = ["PINNConfig", "TensorPinn", "config_to_meta", "config_from_meta"]

PORTED_MODES = ("tt", "tonn")


@dataclasses.dataclass(frozen=True)
class PINNConfig:
    """Every field of ``repro.core.pinn.PINNConfig``, so checkpoint meta
    round-trips.  The serving slice reads ``hidden``, ``mode``,
    ``tt_rank``, ``tt_L``, ``pde``, ``noise`` and ``quant``; the others
    configure training.  ``use_fused_kernel`` picks nothing here: the TT
    layers always go through ``kernels.ops.tt_linear``."""

    space_dim: int = 20
    hidden: int = 1024
    mode: str = "tonn"          # dense | onn | tt | tonn
    tt_rank: int = 2            # paper: ranks [1,2,1,2,1]
    tt_L: int = 4               # paper: 1024 = [4,8,4,8] · [8,4,8,4]
    fd_step: float | None = None
    deriv: str = "fd"
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
    written by a newer version still load); missing keys take defaults."""
    fields = {f.name for f in dataclasses.fields(PINNConfig)}
    kw = {k: v for k, v in meta.items() if k in fields}
    for key, cls in (("noise", photonic.NoiseModel),
                     ("quant", quant_lib.QuantConfig)):
        if isinstance(kw.get(key), dict):
            sub = {f.name for f in dataclasses.fields(cls)}
            kw[key] = cls(**{k: v for k, v in kw[key].items() if k in sub})
    return PINNConfig(**kw)


class TensorPinn:
    """The paper's 3-layer sine MLP in a TT parametrization, solving a
    registered PDE problem (``cfg.pde`` or an explicit instance)."""

    def __init__(self, cfg: PINNConfig,
                 problem: pde_lib.PDEProblem | None = None):
        if cfg.mode not in PORTED_MODES:
            raise NotImplementedError(
                f"mode {cfg.mode!r} is not ported yet; "
                f"the port has {PORTED_MODES}")
        self.cfg = cfg
        self.problem = problem if problem is not None \
            else pde_lib.get_problem(cfg.pde)
        self.space_dim = self.problem.space_dim
        self.in_dim = self.problem.in_dim
        self.net_in = self.problem.net_dim
        h = cfg.hidden
        # pad the input up to a TT-factorizable width (the paper folds
        # 21 → 1024 so layer 1 is a 1024×1024 TT matrix)
        self.in_pad = h if h >= self.net_in else -(-self.net_in // 8) * 8
        self.dims = [(h, self.in_pad), (h, h), (1, h)]
        self.specs = [
            tt.hjb_layer_spec(h, self.in_pad, L=cfg.tt_L, max_rank=cfg.tt_rank),
            tt.hjb_layer_spec(h, h, L=cfg.tt_L, max_rank=cfg.tt_rank),
        ]
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
        return self.cfg.noise.enabled and self.cfg.mode == "tonn"

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> dict:
        """Random params, drawn on the CPU from ``generator`` (the same
        weights for a seed on every device); the caller moves them."""
        cfg = self.cfg
        params: dict = {}
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

    def sample_noise(self, generator: torch.Generator) -> dict | None:
        """One chip's fabrication noise (fixed for the chip's lifetime),
        drawn on the CPU, or None when the forward uses none."""
        if not self.uses_noise:
            return None
        return {f"pcores{i}": [pm.sample_noise(generator, self.cfg.noise)
                               for pm in pms]
                for i, pms in enumerate(self.photonic_cores)}

    # --------------------------------------------------------------- forward
    def _densify_cores(self, params: dict, noise: dict | None, i: int) -> list:
        """TONN layer i: densify each (small) core mesh into its TT-core."""
        spec = self.specs[i]
        cores = []
        for k, pm in enumerate(self.photonic_cores[i]):
            nz = None if noise is None else noise[f"pcores{i}"][k]
            w = pm.to_dense(params[f"pcores{i}"][k],
                            self.cfg.noise if nz else None, nz)
            cores.append(w.reshape(spec.core_shapes[k]).contiguous())
        return cores

    def prepare_params(self, params: dict, noise: dict | None) -> tuple:
        """Densify TONN meshes into plain TT-cores once, noise baked in.

        Returns ``(effective_params, effective_noise)``; a no-op for ``tt``
        and for already-prepared dicts."""
        if self.cfg.mode != "tonn" or "cores0" in params:
            return params, noise
        eff = {k: v for k, v in params.items() if not k.startswith("pcores")}
        for i in range(len(self.specs)):
            eff[f"cores{i}"] = self._densify_cores(params, noise, i)
        return eff, None

    def _layer_matvec(self, params: dict, noise: dict | None, i: int,
                      x: torch.Tensor) -> torch.Tensor:
        cores = params.get(f"cores{i}")
        if cores is None:  # unprepared tonn params: densify on the fly
            cores = self._densify_cores(params, noise, i)
        return ops.tt_linear(x, cores, self.specs[i])

    def _embed(self, xt: torch.Tensor) -> torch.Tensor:
        """Raw rows (..., net_in) → network inputs (..., in_pad), zero-padded."""
        return torch.nn.functional.pad(xt, (0, self.in_pad - self.net_in))

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
