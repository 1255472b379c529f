"""High-dimensional heat equation with a closed-form Gaussian solution.

    ∂_t u + Δ_x u = 0,   u(x, 1) = exp(−‖x−c‖² / (4s)),
    x ∈ [0,1]^D, t ∈ [0,1],  c = ½·1,  s = D/4;
    exact solution u = (s/τ)^{D/2} · exp(−‖x−c‖² / (4τ)),  τ = s + 1 − t.

The ansatz u = (1−t)·f + g(x), g the terminal Gaussian, makes the terminal
condition exact, so the training loss is the residual alone.  The port has
the κ = 1 problem; the diffusivity pin, the κ family and its boundary faces
are ROADMAP item 10.
"""

from __future__ import annotations

import torch

from repro_torch.core import stein
from repro_torch.pde import base


class HeatProblem(base.PDEProblem):
    """Backward heat equation u_t + Δu = 0 with Gaussian terminal data."""

    time_dependent = True
    has_boundary_loss = False
    # u ∈ [e⁻²·e^{−D/16·…}, 1] is O(1); the residual is a pure sum of D FD
    # second differences, each carrying ~ε/h² = 1e-3 f32 rounding → the
    # mean-squared exact-solution residual sits near D·1e-6 ≲ 1e-3.  The
    # h²-truncation term is smaller (u⁗ ~ (4s)⁻² ≪ 1).
    residual_tol = 1e-2

    def __init__(self, space_dim: int = 20, margin: float = 0.02):
        self.space_dim = space_dim
        self.name = f"heat-{space_dim}d"
        self.margin = margin
        self.s = space_dim / 4.0
        self.center = 0.5

    def sample_collocation(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return base.uniform_box(generator, n, self.in_dim, self.margin,
                                1.0 - self.margin)

    def _terminal(self, x: torch.Tensor) -> torch.Tensor:
        """g(x) = exp(−‖x−c‖²/(4s))."""
        q = torch.sum((x - self.center) ** 2, dim=-1)
        return torch.exp(-q / (4.0 * self.s))

    def ansatz(self, f: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
        """u = (1−t)·f + g(x)."""
        D = self.space_dim
        x, t = xt[..., :D], xt[..., D]
        return (1.0 - t) * f + self._terminal(x)

    def residual(self, est: stein.DerivativeEstimate,
                 xt: torch.Tensor) -> torch.Tensor:
        """residual = u_t + Δ_x u."""
        D = self.space_dim
        u_t = est.grad[..., D]
        lap = torch.sum(est.hess_diag[..., :D], dim=-1)
        return u_t + lap

    def spectral_carrier(self, rows: torch.Tensor, anchors: torch.Tensor):
        """β = g(x), the terminal Gaussian of the ansatz u = (1−t)·f + g,
        differentiated analytically: ∂_i g = −(x_i−c)/(2s)·g, ∂²_i g =
        (−1/(2s) + (x_i−c)²/(4s²))·g, ∂_t g = 0."""
        D = self.space_dim
        beta = self._terminal(rows[..., :D])
        xa = anchors[..., :D] - self.center
        ga = self._terminal(anchors[..., :D])[..., None]
        grad_x = -xa / (2.0 * self.s) * ga
        hess_x = (-1.0 / (2.0 * self.s)
                  + xa * xa / (4.0 * self.s * self.s)) * ga
        zeros_t = torch.zeros_like(anchors[..., D:D + 1])
        return (beta, torch.cat([grad_x, zeros_t], dim=-1),
                torch.cat([hess_x, zeros_t], dim=-1))

    def exact_solution(self, xt: torch.Tensor) -> torch.Tensor:
        D = self.space_dim
        x, t = xt[..., :D], xt[..., D]
        tau = self.s + 1.0 - t
        q = torch.sum((x - self.center) ** 2, dim=-1)
        return (self.s / tau) ** (D / 2.0) * torch.exp(-q / (4.0 * tau))


@base.register("heat-10d")
def _heat_10d() -> HeatProblem:
    return HeatProblem(space_dim=10)


@base.register("heat-20d")
def _heat_20d() -> HeatProblem:
    return HeatProblem(space_dim=20)
