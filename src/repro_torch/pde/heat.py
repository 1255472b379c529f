"""High-dimensional heat equation with a closed-form Gaussian solution.

    ∂_t u + κ Δ_x u = 0,   u(x, 1) = exp(−‖x−c‖² / (4s)),
    x ∈ [0,1]^D, t ∈ [0,1],  c = ½·1,  s = D/4;
    exact solution u = (s/τ)^{D/2} · exp(−‖x−c‖² / (4τ)),  τ = s + κ(1 − t),

for every diffusivity κ.  The ansatz u = (1−t)·f + g(x), g the terminal
Gaussian, makes the terminal condition exact for every κ.

``kappa`` pins one diffusivity; ``kappa_range`` conditions the problem on
κ (a trailing input slot sampled per row: ``heat-10d-kappa``).  Backward
heat on a box is well posed only with spatial boundary data, so every
instance but the κ = 1 one trains against closed-form Dirichlet faces
(``boundary_batch``); the κ = 1 problem keeps its residual-only loss.

Port of ``repro.pde.heat``.
"""

from __future__ import annotations

import torch

from repro_torch.core import stein
from repro_torch.pde import base


class HeatProblem(base.PDEProblem):
    """Backward heat equation u_t + κΔu = 0 with Gaussian terminal data."""

    time_dependent = True
    has_boundary_loss = False
    # u ∈ [e⁻²·e^{−D/16·…}, 1] is O(1); the residual is a pure sum of D FD
    # second differences, each carrying ~ε/h² = 1e-3 f32 rounding → the
    # mean-squared exact-solution residual sits near D·1e-6 ≲ 1e-3.  The
    # h²-truncation term is smaller (u⁗ ~ (4s)⁻² ≪ 1); conditioned rows
    # scale it by κ² ≤ 4 over the default range.
    residual_tol = 1e-2

    def __init__(self, space_dim: int = 20, margin: float = 0.02,
                 kappa: float = 1.0,
                 kappa_range: tuple[float, float] | None = None):
        self.space_dim = space_dim
        self.name = f"heat-{space_dim}d"
        self.margin = margin
        self.s = space_dim / 4.0
        self.center = 0.5
        self.kappa = float(kappa)
        if kappa_range is not None:
            self.coeff_spec = base.CoeffSpec(
                ("kappa",), (kappa_range[0],), (kappa_range[1],))
            self.name += "-kappa"
        self.has_boundary_loss = (kappa_range is not None
                                  or self.kappa != 1.0)

    @property
    def _legacy(self) -> bool:
        """The κ = 1 unconditioned problem, whose expressions stay as
        they were."""
        return self.coeff_spec is None and self.kappa == 1.0

    def _kappa(self, xt: torch.Tensor):
        """κ per row (conditioned) or the fixed scalar."""
        if self.coeff_spec is None:
            return self.kappa
        return xt[..., self.in_dim]

    def sample_collocation(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return self._sample_with_coeffs(
            generator, n, lambda g: base.uniform_box(
                g, n, self.in_dim, self.margin, 1.0 - self.margin))

    def _terminal(self, x: torch.Tensor) -> torch.Tensor:
        """g(x) = exp(−‖x−c‖²/(4s))."""
        q = torch.sum((x - self.center) ** 2, dim=-1)
        return torch.exp(-q / (4.0 * self.s))

    def ansatz(self, f: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
        """u = (1−t)·f + g(x)."""
        D = self.space_dim
        x, t = xt[..., :D], xt[..., D]
        return (1.0 - t) * f + self._terminal(x)

    def boundary_batch(self, generator: torch.Generator, n: int):
        """n Dirichlet rows on the spatial faces of the box: one coordinate
        pinned to a face, t (and κ, when conditioned) sampled; the targets
        are the closed form, the boundary data of the well-posed problem
        per coefficient instance.  None for the κ = 1 problem."""
        if not self.has_boundary_loss:
            return None
        D, m = self.space_dim, self.margin
        x = m + (1.0 - 2 * m) * torch.rand((n, D), generator=generator)
        face = torch.randint(0, D, (n,), generator=generator)
        side = torch.randint(0, 2, (n,), generator=generator).to(x.dtype)
        x[torch.arange(n), face] = side
        t = m + (1.0 - 2 * m) * torch.rand((n, 1), generator=generator)
        xt = torch.cat([x, t], dim=-1)
        if self.coeff_spec is not None:
            xt = torch.cat([xt, self.coeff_spec.sample(generator, n)],
                           dim=-1)
        return xt, self.exact_solution(xt)

    def residual(self, est: stein.DerivativeEstimate,
                 xt: torch.Tensor) -> torch.Tensor:
        """residual = u_t + κ Δ_x u."""
        D = self.space_dim
        u_t = est.grad[..., D]
        lap = torch.sum(est.hess_diag[..., :D], dim=-1)
        if self._legacy:
            return u_t + lap
        return u_t + self._kappa(xt) * lap

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
        if self._legacy:
            tau = self.s + 1.0 - t
        else:
            tau = self.s + self._kappa(xt) * (1.0 - t)
        q = torch.sum((x - self.center) ** 2, dim=-1)
        return (self.s / tau) ** (D / 2.0) * torch.exp(-q / (4.0 * tau))


@base.register("heat-10d")
def _heat_10d() -> HeatProblem:
    return HeatProblem(space_dim=10)


@base.register("heat-20d")
def _heat_20d() -> HeatProblem:
    return HeatProblem(space_dim=20)


@base.register("heat-10d-kappa")
def _heat_10d_kappa() -> HeatProblem:
    """The conditioned family: diffusivity κ ∈ [0.5, 2.0] an input slot."""
    return HeatProblem(space_dim=10, kappa_range=(0.5, 2.0))
