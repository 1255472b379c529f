"""2-D Helmholtz equation with a Dirichlet boundary loss: the first problem
of the port with a boundary ``LossTerm`` (L_b of paper Eq. 4).

    Δu + k² u = q(x),   x ∈ [0,1]²,      u = 0 on ∂[0,1]²,
    q(x) = (k² − (a₁² + a₂²) π²) · sin(a₁πx₁) sin(a₂πx₂),

manufactured so the exact solution is u* = sin(a₁πx₁) sin(a₂πx₂), which
vanishes on the boundary.  Steady state (``time_dependent = False``): the
network input is x alone.

There is no hard-constraint ansatz (T = identity): the Dirichlet condition
is enforced softly through L = L_r + λ·L_b, with boundary points drawn
uniformly on ∂[0,1]².

Port of ``repro.pde.helmholtz``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import stein
from repro_torch.pde import base


class HelmholtzProblem(base.PDEProblem):
    """Δu + k²u = q on [0,1]², soft Dirichlet boundary via L_b."""

    space_dim = 2
    time_dependent = False
    has_boundary_loss = True
    bc_weight = 1.0
    # central-difference truncation on sin(aπx): (h²/12)·(aπ)⁴·|u*| per
    # second derivative, ~1.3e-2·|u*| at a₂ = 2, h = 1e-2, above the f32
    # rounding; after the 1/|c| scaling (see __init__) the mean-squared
    # exact-solution residual sits near 2.5e-8
    residual_tol = 1e-6

    def __init__(self, k: float = 1.0, a: tuple = (1, 2),
                 margin: float = 0.02):
        self.name = "helmholtz-2d"
        self.k = k
        self.a = a
        self.margin = margin
        # the source coefficient k² − (a₁²+a₂²)π² ≈ −48 would make L_r
        # dwarf L_b by ~3 orders of magnitude; the residual is reported in
        # units of it (the same zero set, a conditioned loss)
        self.scale = abs(k ** 2 - (a[0] ** 2 + a[1] ** 2) * math.pi ** 2)

    def sample_collocation(self, generator: torch.Generator,
                           n: int) -> torch.Tensor:
        return base.uniform_box(generator, n, self.in_dim, self.margin,
                                1.0 - self.margin)

    def ansatz(self, f: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
        """Identity: the boundary condition is soft (L_b), not hard-wired."""
        return f

    def _u_star(self, x: torch.Tensor) -> torch.Tensor:
        a1, a2 = self.a
        return torch.sin(a1 * math.pi * x[..., 0]) \
            * torch.sin(a2 * math.pi * x[..., 1])

    def source(self, x: torch.Tensor) -> torch.Tensor:
        """q = (k² − (a₁²+a₂²)π²) u*, manufactured for u* exact."""
        a1, a2 = self.a
        coef = self.k ** 2 - (a1 ** 2 + a2 ** 2) * math.pi ** 2
        return coef * self._u_star(x)

    def residual(self, est: stein.DerivativeEstimate,
                 xt: torch.Tensor) -> torch.Tensor:
        """(Δu + k²u − q(x)) / |k² − (a₁²+a₂²)π²| (see __init__)."""
        lap = torch.sum(est.hess_diag, dim=-1)
        return (lap + self.k ** 2 * est.u - self.source(xt)) / self.scale

    def boundary_batch(self, generator: torch.Generator, n: int):
        """n points uniform on ∂[0,1]² with the Dirichlet target u = 0
        (float32, on the CPU): each point draws its position along a side,
        then one of the 4 sides."""
        along = torch.rand((n,), generator=generator)
        side = torch.randint(0, 4, (n,), generator=generator)
        fixed = (side % 2).to(torch.float32)          # 0 or 1 coordinate
        horiz = side < 2                              # which axis is pinned
        xb = torch.stack([torch.where(horiz, fixed, along),
                          torch.where(horiz, along, fixed)], dim=-1)
        return xb, torch.zeros((n,))

    def exact_solution(self, xt: torch.Tensor) -> torch.Tensor:
        return self._u_star(xt)


@base.register("helmholtz-2d")
def _helmholtz_2d() -> HelmholtzProblem:
    return HelmholtzProblem()
