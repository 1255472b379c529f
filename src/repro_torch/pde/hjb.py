"""The paper's Hamilton–Jacobi–Bellman benchmark (paper Eq. 7, §4).

    ∂_t u + Δu − λ ‖∇_x u‖₂² = −2,   λ = 1/D (paper: 0.05 at D = 20),
    u(x, 1) = ‖x‖₁,  x ∈ [0,1]^D, t ∈ [0,1];
    exact solution u = ‖x‖₁ + (2 − λD)(1 − t)  (‖x‖₁ + 1 − t at λ = 1/D).

The ansatz u = (1−t)·f + ‖x‖₁ satisfies the terminal condition exactly
for every λ, so training minimizes the residual loss alone (no L_b term).
``lam`` pins one control cost; ``lam_range`` conditions the problem on λ
(a trailing input slot sampled per row: ``hjb-10d-lam``).  The default
λ = 1/D keeps the paper's expressions as they were.

Port of ``repro.pde.hjb``.
"""

from __future__ import annotations

import torch

from repro_torch.core import stein
from repro_torch.pde import base


class HJBProblem(base.PDEProblem):
    """Paper Eq. 7 in ``space_dim`` spatial dimensions (paper: 20)."""

    time_dependent = True
    has_boundary_loss = False
    # float32 FD second derivatives carry ~ε·|u|/h² rounding per dim, summed
    # over the D Laplacian terms
    residual_tol = 5e-2

    def __init__(self, space_dim: int = 20, margin: float = 0.02,
                 lam: float | None = None,
                 lam_range: tuple[float, float] | None = None):
        self.space_dim = space_dim
        self.name = f"hjb-{space_dim}d"
        self.margin = margin
        # at λ = 1/D the time slope 2 − λD is exactly 1; the default keeps
        # the literal 1 − t (2 − (1/D)·D rounds off 1 for most D)
        self._lam_default = lam is None and lam_range is None
        self.lam = (1.0 / space_dim) if lam is None else float(lam)
        if lam_range is not None:
            self.coeff_spec = base.CoeffSpec(
                ("lam",), (lam_range[0],), (lam_range[1],))
            self.name += "-lam"

    def _lam(self, xt: torch.Tensor):
        """λ per row (conditioned) or the fixed scalar."""
        if self.coeff_spec is None:
            return self.lam
        return xt[..., self.in_dim]

    def sample_collocation(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Uniform (x, t) ∈ [margin, 1−margin]^{D+1} (away from the |x| kink
        at 0 and from the domain boundary)."""
        return self._sample_with_coeffs(
            generator, n, lambda g: base.uniform_box(
                g, n, self.in_dim, self.margin, 1.0 - self.margin))

    def ansatz(self, f: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
        """u = (1−t)·f + ‖x‖₁."""
        D = self.space_dim
        x, t = xt[..., :D], xt[..., D]
        return (1.0 - t) * f + torch.sum(torch.abs(x), dim=-1)

    def residual(self, est: stein.DerivativeEstimate,
                 xt: torch.Tensor) -> torch.Tensor:
        """Paper Eq. 7: u_t + Δ_x u − λ ‖∇_x u‖² + 2, λ = 1/D unless pinned
        or conditioned."""
        D = self.space_dim
        u_t = est.grad[..., D]
        grad_x = est.grad[..., :D]
        lap = torch.sum(est.hess_diag[..., :D], dim=-1)
        return (u_t + lap
                - self._lam(xt) * torch.sum(grad_x * grad_x, dim=-1) + 2.0)

    def spectral_carrier(self, rows: torch.Tensor, anchors: torch.Tensor):
        """β = ‖x‖₁, the ansatz's closed-form part, whose kink at x_i = 0
        spectral line segments near the domain's edge cross.  Taking it out
        leaves the smooth (1−t)·f; ∂_i β = sign(x_i), ∂_t β = 0, diag ∇²β
        = 0."""
        D = self.space_dim
        beta = torch.sum(torch.abs(rows[..., :D]), dim=-1)
        grad = torch.cat([torch.sign(anchors[..., :D]),
                          torch.zeros_like(anchors[..., D:D + 1])], dim=-1)
        return beta, grad, torch.zeros_like(grad)

    def exact_solution(self, xt: torch.Tensor) -> torch.Tensor:
        """u(x,t) = ‖x‖₁ + (2 − λD)(1 − t)  (‖x‖₁ + 1 − t at λ = 1/D)."""
        D = self.space_dim
        x, t = xt[..., :D], xt[..., D]
        l1 = torch.sum(torch.abs(x), dim=-1)
        if self._lam_default:
            return l1 + 1.0 - t
        return l1 + (2.0 - self._lam(xt) * D) * (1.0 - t)


@base.register("hjb-20d")
def _hjb_20d() -> HJBProblem:
    return HJBProblem(space_dim=20)


@base.register("hjb-10d")
def _hjb_10d() -> HJBProblem:
    return HJBProblem(space_dim=10)


@base.register("hjb-10d-lam")
def _hjb_10d_lam() -> HJBProblem:
    """The conditioned family: control cost λ ∈ [0.05, 0.15] (1/D = 0.1
    its middle)."""
    return HJBProblem(space_dim=10, lam_range=(0.05, 0.15))
