"""PDE problem registry, every problem trainable: ``hjb-20d`` / ``hjb-10d``
(the paper's HJB benchmark), ``heat-10d`` / ``heat-20d`` (Gaussian exact
solution), ``black-scholes-100d`` (the 100-asset Black–Scholes–Barenblatt
benchmark), ``helmholtz-2d`` (steady Helmholtz with a Dirichlet boundary
loss, paper Eq. 4's L_b) and ``ns-2d`` (2-D Navier–Stokes in vorticity form
on a periodic box: a ``Domain``, a Fourier feature map, three loss terms,
trained by the spectral estimator), and the coefficient-conditioned
families, one checkpoint over a sampled coefficient range, each with a
closed form per coefficient: ``heat-10d-kappa`` (diffusivity κ ∈ [0.5,
2]), ``hjb-10d-lam`` (control cost λ ∈ [0.05, 0.15]) and
``black-scholes-8d-rs`` / ``black-scholes-100d-rs`` (rate r ∈ [0.01, 0.1]
× volatility σ ∈ [0.2, 0.6]).  ``get_problem(name)`` resolves a name to a
fresh problem; ``estimate_for_problem`` estimates u's derivatives the way
a problem is trained."""

from repro_torch.pde.base import (CoeffSpec, Domain, LossTerm, PDEProblem,
                                  available, estimate_for_problem,
                                  estimate_from_u_stencil, fd_stencil_points,
                                  get_problem, register, uniform_box)
from repro_torch.pde.black_scholes import BlackScholesProblem  # registers
from repro_torch.pde.heat import HeatProblem
from repro_torch.pde.helmholtz import HelmholtzProblem
from repro_torch.pde.hjb import HJBProblem
from repro_torch.pde.navier_stokes import NavierStokes2D

__all__ = ["CoeffSpec", "Domain", "LossTerm", "PDEProblem", "register",
           "get_problem", "available", "uniform_box", "fd_stencil_points",
           "estimate_from_u_stencil", "estimate_for_problem", "HJBProblem",
           "HeatProblem", "BlackScholesProblem", "HelmholtzProblem",
           "NavierStokes2D"]
