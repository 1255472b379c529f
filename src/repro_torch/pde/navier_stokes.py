"""2-D incompressible Navier–Stokes (vorticity form) on a periodic box: the
port's first problem with three loss terms (collocation, initial slice,
noisy data), a ``Domain`` and an input feature map.

Vorticity transport on the 2π-periodic box, ν = 0.1:

    ω_t + u·∇ω = ν Δω,      (x, y) ∈ [0, 2π]²,  t ∈ [0, 1],

validated against the Taylor–Green vortex

    ω*(x, y, t) = 2 cos x cos y e^{−2νt},
    u*(x, y, t) = −cos x sin y e^{−2νt},   v*(x, y, t) = sin x cos y e^{−2νt},

for which u·∇ω ≡ 0 pointwise, so ω_t = νΔω = −2νω exactly.  The transport
velocity in the residual is the closed-form Taylor–Green field at the
collocation points (frozen-velocity vorticity transport): a pointwise
velocity is not recoverable from a vorticity ``DerivativeEstimate`` without
a Poisson solve.

Three loss terms:

  * ``residual``: collocation over the unit-normalized space–time box;
  * ``ic``: a boundary-kind soft initial condition on the t = 0 slice,
    target ω₀ = 2 cos x cos y (the ansatz is the identity);
  * ``data``: noisy observations of ω* (σ = ``data_noise``) at uniform
    interior points.

The problem declares ``Domain([0,2π]²×[0,1])``, and every sampler emits
unit-box rows z; ``scale_estimate`` folds the Jacobian (∂_x = ∂_z/2π,
∂²_x = ∂²_z/4π²) into each estimate.  On the unit box the 2π period is
period 1 = ``spectral_extent``, so the periodic rfft differentiates ω*
exactly along x and y; the non-periodic time axis takes the windowed path:
``spectral_periodization = ("periodic", "periodic", "window")``.  A Fourier
feature map (cos 2πz_x, sin 2πz_x, cos 2πz_y, sin 2πz_y, z_t) makes the
network itself exactly periodic.  It is not affine, so ``fd_fast`` runs as
plain ``fd`` here (``core.pinn``).

The samplers draw from a ``torch.Generator`` (on the CPU), not threefry:
the same seed gives other points than the JAX package's, so parity tests
hand both packages the same arrays.

Port of ``repro.pde.navier_stokes``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import stein
from repro_torch.pde import base

TWO_PI = 2.0 * math.pi


class NavierStokes2D(base.PDEProblem):
    """ω_t + u*·∇ω = νΔω on [0,2π]²×[0,1] (Taylor–Green validation)."""

    space_dim = 2
    time_dependent = True
    has_boundary_loss = True      # the "ic" term
    bc_weight = 1.0
    has_data_loss = True
    data_weight = 1.0
    fd_step = 1e-2                # in unit-box coordinates
    # exact-solution residual floors (MSE): the declared spectral estimator
    # ~4e-11 (x, y FFT-exact, t windowed on a gentle trend), f32 FD at
    # fd_step ~4e-9
    residual_tol = 1e-7
    domain = base.Domain((0.0, 0.0, 0.0), (TWO_PI, TWO_PI, 1.0))
    estimator = "spectral"
    spectral_points = 16
    spectral_extent = 1.0         # one unit-box period per axis
    spectral_periodization = ("periodic", "periodic", "window")

    def __init__(self, nu: float = 0.1, margin: float = 0.02,
                 data_noise: float = 0.05):
        self.name = "ns-2d"
        self.nu = nu
        self.margin = margin        # t axis only; x, y are periodic
        self.data_noise = data_noise

    # ------------------------------------------------------------ closed form
    def _decay(self, t_raw: torch.Tensor) -> torch.Tensor:
        return torch.exp(-2.0 * self.nu * t_raw)

    def _omega_star(self, raw: torch.Tensor) -> torch.Tensor:
        """Taylor–Green vorticity at raw coordinates (..., 3)."""
        return (2.0 * torch.cos(raw[..., 0]) * torch.cos(raw[..., 1])
                * self._decay(raw[..., 2]))

    def _velocity_star(self, raw: torch.Tensor) -> tuple:
        """The closed-form transport field (u*, v*) at raw coordinates."""
        e = self._decay(raw[..., 2])
        u = -torch.cos(raw[..., 0]) * torch.sin(raw[..., 1]) * e
        v = torch.sin(raw[..., 0]) * torch.cos(raw[..., 1]) * e
        return u, v

    # -------------------------------------------------------------- interface
    def sample_collocation(self, generator: torch.Generator,
                           n: int) -> torch.Tensor:
        """(n, 3) unit-box rows: x, y uniform over the whole period (FD
        stencils may wrap: the network and ω* are periodic), t margined so
        stencils stay inside [0, 1]."""
        xy = torch.rand((n, 2), generator=generator)
        t = base.uniform_box(generator, n, 1, self.margin, 1.0 - self.margin)
        return torch.cat([xy, t], dim=-1)

    def ansatz(self, f: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
        """Identity: the initial condition is fitted softly (``ic``)."""
        return f

    def embed_features(self, xt: torch.Tensor) -> torch.Tensor:
        """Unit rows (..., 3) → (cos 2πz_x, sin 2πz_x, cos 2πz_y,
        sin 2πz_y, z_t): the network becomes exactly 1-periodic in the
        spatial coordinates."""
        zx = TWO_PI * xt[..., 0]
        zy = TWO_PI * xt[..., 1]
        return torch.stack([torch.cos(zx), torch.sin(zx), torch.cos(zy),
                            torch.sin(zy), xt[..., 2]], dim=-1)

    @property
    def feature_dim(self) -> int:
        return 5

    def residual(self, est: stein.DerivativeEstimate,
                 xt: torch.Tensor) -> torch.Tensor:
        """ω_t + u*·∇ω − νΔω at the (unit-box) anchors; ``est`` arrives
        Jacobian-scaled, in raw units.  Broadcasts over leading stacked
        axes of the estimate's leaves."""
        raw = self.domain.from_unit(xt)
        u, v = self._velocity_star(raw)
        advect = u * est.grad[..., 0] + v * est.grad[..., 1]
        lap = est.hess_diag[..., 0] + est.hess_diag[..., 1]
        return est.grad[..., 2] + advect - self.nu * lap

    def loss_terms(self) -> tuple:
        return self._apply_term_weights([
            base.LossTerm("residual", "collocation", 1.0,
                          self.sample_collocation),
            base.LossTerm("ic", "boundary", self.bc_weight,
                          self.initial_batch),
            base.LossTerm("data", "data", self.data_weight,
                          self.data_batch),
        ])

    def initial_batch(self, generator: torch.Generator, n: int):
        """(zb, ω₀) on the t = 0 slice: ω₀(x, y) = 2 cos x cos y."""
        xy = torch.rand((n, 2), generator=generator)
        zb = torch.cat([xy, torch.zeros((n, 1))], dim=-1)
        return zb, self.exact_solution(zb)

    def boundary_batch(self, generator: torch.Generator, n: int):
        """The deprecated boundary entry: the ``ic`` term's sampler."""
        return self.initial_batch(generator, n)

    def data_batch(self, generator: torch.Generator, n: int):
        """(z_d, ω* + σ·ξ): noisy observations at uniform interior rows,
        points and noise both from ``generator``, so a counter-keyed
        stream replays the same observations."""
        zd = torch.rand((n, 3), generator=generator)
        noise = torch.randn((n,), generator=generator)
        return zd, self.exact_solution(zd) + self.data_noise * noise

    def exact_solution(self, xt: torch.Tensor) -> torch.Tensor:
        """ω* at unit-box rows (the coordinates every consumer holds)."""
        return self._omega_star(self.domain.from_unit(xt))


@base.register("ns-2d")
def _ns_2d() -> NavierStokes2D:
    return NavierStokes2D()
