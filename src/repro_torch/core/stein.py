"""BP-free derivative estimation — the paper's §3.3 "BP-free Loss Evaluation".

PINN residuals need ∂u/∂t, ∇_x u and Δu.  On a photonic chip autodiff is
unavailable, so derivatives are estimated from additional inferences at
coordinate-wise perturbed inputs, by central finite differences (the
paper's 42 inferences per loss evaluation = 2 × 21 perturbed batches for a
21-dim input):

    ∂_i u ≈ (u(x + h e_i) − u(x − h e_i)) / (2h)
    ∂²_i u ≈ (u(x + h e_i) − 2 u(x) + u(x − h e_i)) / h²

Port of ``repro.core.stein``; the Stein estimator is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["DerivativeEstimate", "fd_estimate", "num_fd_inferences"]


@dataclasses.dataclass
class DerivativeEstimate:
    """u, ∇u and the Hessian diagonal at each collocation point: ``u``
    ``(..., B)``, ``grad`` and ``hess_diag`` ``(..., B, A)`` over the A
    differentiated coordinates (leading axes: a stack of models)."""

    u: torch.Tensor
    grad: torch.Tensor
    hess_diag: torch.Tensor

    def laplacian(self, dims: slice | None = None) -> torch.Tensor:
        h = self.hess_diag if dims is None else self.hess_diag[..., dims]
        return torch.sum(h, dim=-1)


def num_fd_inferences(d: int, n_active: int | None = None) -> int:
    """Stacked rows per ``fd_estimate`` loss evaluation: the base batch
    plus 2A coordinate perturbations, **2A + 1** with A = ``n_active``
    (A = d when None)."""
    a = d if n_active is None else n_active
    return 2 * a + 1


def fd_estimate(f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                h: float = 1e-2,
                n_active: int | None = None) -> DerivativeEstimate:
    """Central finite differences via one stacked forward.

    x: (B, D).  Evaluates f once on the (2A+1, B, D) stencil
    [x, x+h e_1, ..., x+h e_A, x−h e_1, ..., x−h e_A] and assembles the
    first and second derivatives of the first A coordinates (A = D when
    ``n_active`` is None)."""
    from repro_torch.pde.base import estimate_from_u_stencil, fd_stencil_points
    B, D = x.shape
    A = D if n_active is None else n_active
    pts = fd_stencil_points(x, h, A)
    vals = f(pts.reshape((2 * A + 1) * B, D)).reshape(2 * A + 1, B)
    return estimate_from_u_stencil(vals, h)
