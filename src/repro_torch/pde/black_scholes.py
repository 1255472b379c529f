"""100-dim Black–Scholes–Barenblatt terminal-value PDE.

The standard high-dimensional BSDE benchmark in PINN form:

    ∂_t u + ½σ² Σ_i x_i² ∂²_i u − r (u − Σ_i x_i ∂_i u) = 0,
    u(x, 1) = ‖x‖² / D,   x ∈ [0.5, 1.5]^D, t ∈ [0,1],

with closed-form solution  u(x, t) = exp((r + σ²)(1 − t)) · ‖x‖² / D
for every rate r and volatility σ.  The 1/D normalization of the terminal
payoff keeps u O(1) at D = 100 instead of O(D), which float32 FD second
differences need.

Ansatz: u = (1−t)·f + ‖x‖²/D — terminal condition exact, residual-only loss.
Default σ = 0.4, r = 0.05 (the literature's configuration).  ``r_range``
and ``sigma_range`` (both or neither) condition the problem on (r, σ), two
trailing input slots sampled per row (the ``-rs`` registrations); the
fixed ``r`` / ``sigma`` pin one scenario.

Port of ``repro.pde.black_scholes``.
"""

from __future__ import annotations

import torch

from repro_torch.core import stein
from repro_torch.pde import base


class BlackScholesProblem(base.PDEProblem):
    """Black–Scholes–Barenblatt equation in ``space_dim`` assets."""

    time_dependent = True
    has_boundary_loss = False
    # u ~ O(1) after the 1/D payoff normalization; the Laplacian term's D
    # independent ±ε/h² FD rounding contributions (weighted by ½σ²x_i²)
    # accumulate like √D · ½σ²·x̄²·1e-3 ≈ 2e-3 at D=100 → mean-squared
    # exact-solution residual ≲ 1e-4; truncation is O(h²) and smaller.
    residual_tol = 1e-2

    def __init__(self, space_dim: int = 100, sigma: float = 0.4,
                 r: float = 0.05, margin: float = 0.02,
                 r_range: tuple[float, float] | None = None,
                 sigma_range: tuple[float, float] | None = None):
        self.space_dim = space_dim
        self.name = f"black-scholes-{space_dim}d"
        self.sigma = float(sigma)
        self.r = float(r)
        self.margin = margin
        if (r_range is None) != (sigma_range is None):
            raise ValueError("condition on both r and sigma or neither")
        if r_range is not None:
            self.coeff_spec = base.CoeffSpec(
                ("r", "sigma"), (r_range[0], sigma_range[0]),
                (r_range[1], sigma_range[1]))
            self.name += "-rs"

    def _rs(self, xt: torch.Tensor) -> tuple:
        """(r, σ) per row (conditioned) or the fixed scalars."""
        if self.coeff_spec is None:
            return self.r, self.sigma
        D1 = self.in_dim
        return xt[..., D1], xt[..., D1 + 1]

    def sample_collocation(self, generator: torch.Generator,
                           n: int) -> torch.Tensor:
        """x ∈ [0.5+m, 1.5−m]^D, t ∈ [m, 1−m] (the margin keeps FD
        stencils inside the domain)."""
        def points(g):
            pts = base.uniform_box(g, n, self.in_dim, self.margin,
                                   1.0 - self.margin)
            return torch.cat([pts[:, :-1] + 0.5, pts[:, -1:]], dim=-1)
        return self._sample_with_coeffs(generator, n, points)

    def _terminal(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x * x, dim=-1) / self.space_dim

    def ansatz(self, f: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
        """u = (1−t)·f + ‖x‖²/D."""
        D = self.space_dim
        x, t = xt[..., :D], xt[..., D]
        return (1.0 - t) * f + self._terminal(x)

    def spectral_carrier(self, rows: torch.Tensor, anchors: torch.Tensor):
        """β = ‖x‖²/D, the ansatz's closed-form payoff, differentiated
        analytically: ∂_i β = 2x_i/D, diag ∇²β = 2/D, ∂_t β = 0."""
        D = self.space_dim
        beta = self._terminal(rows[..., :D])
        grad_x = 2.0 * anchors[..., :D] / D
        zeros_t = torch.zeros_like(anchors[..., D:D + 1])
        hess_x = torch.full_like(grad_x, 2.0 / D)
        return (beta, torch.cat([grad_x, zeros_t], dim=-1),
                torch.cat([hess_x, zeros_t], dim=-1))

    def residual(self, est: stein.DerivativeEstimate,
                 xt: torch.Tensor) -> torch.Tensor:
        """u_t + ½σ² Σ x_i²∂²_i u − r(u − Σ x_i ∂_i u)."""
        D = self.space_dim
        x = xt[..., :D]
        r, sigma = self._rs(xt)
        u_t = est.grad[..., D]
        diff = 0.5 * sigma ** 2 * torch.sum(
            x * x * est.hess_diag[..., :D], dim=-1)
        drift = r * (est.u - torch.sum(x * est.grad[..., :D], dim=-1))
        return u_t + diff - drift

    def exact_solution(self, xt: torch.Tensor) -> torch.Tensor:
        D = self.space_dim
        x, t = xt[..., :D], xt[..., D]
        r, sigma = self._rs(xt)
        return torch.exp((r + sigma ** 2) * (1.0 - t)) * self._terminal(x)


@base.register("black-scholes-100d")
def _bs_100d() -> BlackScholesProblem:
    return BlackScholesProblem(space_dim=100)


@base.register("black-scholes-8d-rs")
def _bs_8d_rs() -> BlackScholesProblem:
    """The conditioned family at a small dimension: rate r ∈ [0.01, 0.1],
    volatility σ ∈ [0.2, 0.6] as two trailing input slots."""
    return BlackScholesProblem(space_dim=8, r_range=(0.01, 0.1),
                               sigma_range=(0.2, 0.6))


@base.register("black-scholes-100d-rs")
def _bs_100d_rs() -> BlackScholesProblem:
    """The 100-asset benchmark as a conditioned (r, σ) family."""
    return BlackScholesProblem(space_dim=100, r_range=(0.01, 0.1),
                               sigma_range=(0.2, 0.6))
