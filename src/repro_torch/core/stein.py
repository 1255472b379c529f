"""BP-free derivative estimation — the paper's §3.3 "BP-free Loss Evaluation".

PINN residuals need ∂u/∂t, ∇_x u and Δu.  On a photonic chip autodiff is
unavailable, so derivatives are estimated from additional inferences at
perturbed inputs.  Two estimators, as in the paper:

1. **Central finite differences** (the paper's 42 inferences per loss
   evaluation = 2 × 21 perturbed batches for a 21-dim input):

       ∂_i u ≈ (u(x + h e_i) − u(x − h e_i)) / (2h)
       ∂²_i u ≈ (u(x + h e_i) − 2 u(x) + u(x − h e_i)) / h²

2. **Gaussian-smoothing Stein estimator** with antithetic pairs (z, −z):

       ∇u_σ(x)  = E[ u(x + σ z) z ] / σ
       ∂²_i u_σ = E[ u(x + σ z) (z_i² − 1) ] / σ²,   z ~ N(0, I)

Both are one stacked forward over the perturbed inputs.  The Stein draws
come from an explicit ``torch.Generator`` (the reference's PRNG key), or
are handed in as ``z``, which is how the port is held to the reference.

Port of ``repro.core.stein``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["DerivativeEstimate", "fd_estimate", "stein_estimate",
           "stein_directions", "stein_stencil_points",
           "estimate_from_stein_vals", "num_fd_inferences"]


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


def stein_directions(x: torch.Tensor, generator: torch.Generator | None,
                     num_samples: int, n_active: int | None = None,
                     z: torch.Tensor | None = None,
                     lead: tuple = ()) -> torch.Tensor:
    """The Gaussian directions of ``stein_estimate`` for rows x (B, D):
    ``z`` as given, else ``(*lead, S, B, D)`` standard normals drawn from
    ``generator`` on x's device; the directions past the first
    ``n_active`` coordinates are zeroed either way."""
    B, D = x.shape
    if z is None:
        if generator is None:
            raise ValueError("stein estimator needs a generator (or z)")
        z = torch.randn((*lead, num_samples, B, D), generator=generator,
                        dtype=x.dtype, device=x.device)
    if n_active is not None and n_active < D:
        z = z * (torch.arange(D, device=z.device) < n_active).to(z.dtype)
    return z


def stein_stencil_points(x: torch.Tensor, z: torch.Tensor,
                         sigma: float) -> torch.Tensor:
    """(..., 2S+1, B, D) rows [x, x+σz_1, ..., x+σz_S, x−σz_1, ..., x−σz_S]
    from rows x (B, D) and directions z (..., S, B, D)."""
    base = x.expand(*z.shape[:-3], 1, *x.shape)
    return torch.cat([base, x + sigma * z, x - sigma * z], dim=-3)


def estimate_from_stein_vals(vals: torch.Tensor, z: torch.Tensor,
                             sigma: float, n_active: int | None = None
                             ) -> DerivativeEstimate:
    """Assemble (u, ∇u, diag H) from u-values on the Stein stencil: vals
    (..., 2S+1, B) and z (..., S, B, D) → leaves u (..., B) and
    (..., B, A), A = ``n_active`` (D when None)."""
    S = z.shape[-3]
    u0 = vals[..., 0, :]
    up, um = vals[..., 1:S + 1, :], vals[..., S + 1:, :]
    # grad: E[(u+ − u−)/(2σ) · z]
    coeff = (up - um) / (2.0 * sigma)
    grad = torch.einsum("...sb,...sbd->...bd", coeff, z) / S
    # hess diag: for locally-quadratic u, (u+ − 2u0 + u−)/σ² = zᵀHz with
    # E[zᵀHz · z_i²] = 2 H_ii + tr(H) and E[zᵀHz] = tr(H), so
    #   H_ii = ( E[c2 · z_i²] − E[c2] ) / 2
    # — exact for quadratics under antithetic pairing.
    c2 = (up - 2.0 * u0[..., None, :] + um) / (sigma * sigma)
    tr_term = torch.mean(c2, dim=-2)
    hess = (torch.einsum("...sb,...sbd->...bd", c2, z * z) / S
            - tr_term[..., None]) / 2.0
    A = z.shape[-1] if n_active is None else n_active
    return DerivativeEstimate(u=u0, grad=grad[..., :A],
                              hess_diag=hess[..., :A])


def stein_estimate(f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                   generator: torch.Generator | None = None,
                   sigma: float = 5e-2, num_samples: int = 32,
                   n_active: int | None = None,
                   z: torch.Tensor | None = None) -> DerivativeEstimate:
    """Antithetic Gaussian-smoothing Stein estimator: S antithetic pairs,
    2S+1 stacked inferences in one call of f.

      ∇u   ≈ (1/S) Σ [u(x+σz) − u(x−σz)] z / (2σ)
      ∂²_i ≈ ((1/S) Σ c2·z_i² − (1/S) Σ c2) / 2,  c2 = [u(x+σz) − 2u(x)
             + u(x−σz)] / σ²

    x: (B, D).  ``z`` (S, B, D) overrides the draw from ``generator`` (a
    missing generator then raises, as the reference's missing key does).
    ``n_active`` zeroes the directions past the first A coordinates and
    slices the leaves to (B, A)."""
    B, D = x.shape
    z = stein_directions(x, generator, num_samples, n_active, z)
    S = z.shape[-3]
    pts = stein_stencil_points(x, z, sigma)
    vals = f(pts.reshape((2 * S + 1) * B, D)).reshape(2 * S + 1, B)
    return estimate_from_stein_vals(vals, z, sigma, n_active)
