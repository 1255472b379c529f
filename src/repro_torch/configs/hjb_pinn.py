"""The paper's own model: the TT-compressed 3-layer sine MLP, bound to any
registered PDE (port of ``repro.configs.hjb_pinn``).  The Table-1 rows bind
the paper's 20-dim HJB benchmark; ``pinn_config``/``pinn_reduced`` build the
same model for a ``--pde`` of ``repro_torch.launch.train``."""

import dataclasses

from repro_torch.core.photonic import NoiseModel
from repro_torch.core.pinn import PINNConfig

# paper Table 1 rows (the port trains the tt and tonn ones)
ONN_OFFCHIP = PINNConfig(hidden=1024, mode="dense")
ONN_ONCHIP = PINNConfig(hidden=1024, mode="onn",
                        noise=NoiseModel(enabled=True))
TONN_OFFCHIP = PINNConfig(hidden=1024, mode="tt", tt_rank=2, tt_L=4)
TONN_ONCHIP = PINNConfig(hidden=1024, mode="tonn", tt_rank=2, tt_L=4,
                         noise=NoiseModel(enabled=True))

# the fused ZO hot path: incremental FD stencil, stacked TT contraction and
# batched mesh densification through the kernels
TONN_ONCHIP_FUSED = PINNConfig(hidden=1024, mode="tonn", tt_rank=2, tt_L=4,
                               deriv="fd_fast", use_fused_kernel=True,
                               noise=NoiseModel(enabled=True))

REDUCED = PINNConfig(hidden=64, mode="tt", tt_rank=2, tt_L=3)


def pinn_config(pde: str = "hjb-20d", mode: str = "tonn",
                fused: bool = True, noise: bool = False,
                **overrides) -> PINNConfig:
    """Paper-scale ``PINNConfig`` bound to a registered PDE.  ``fused``
    selects the multi-perturbation hot path (``fd_fast`` stencil, stacked
    kernels); ``noise`` enables the fabrication-noise model."""
    base = PINNConfig(hidden=1024, mode=mode, tt_rank=2, tt_L=4, pde=pde,
                      deriv="fd_fast" if fused else "fd",
                      use_fused_kernel=fused,
                      noise=NoiseModel(enabled=noise))
    return dataclasses.replace(base, **overrides) if overrides else base


def pinn_reduced(pde: str = "hjb-20d", mode: str = "tt",
                 fused: bool = True, noise: bool = False,
                 **overrides) -> PINNConfig:
    """CI/CPU-sized variant of ``pinn_config`` (hidden 64, 3 TT cores)."""
    cfg = pinn_config(pde, mode, fused, noise, hidden=64, tt_L=3)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
