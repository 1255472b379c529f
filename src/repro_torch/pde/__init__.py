"""PDE problem registry: ``hjb-20d`` / ``hjb-10d`` (the paper's HJB
benchmark, trainable: its residual is ported) and ``heat-10d`` /
``heat-20d`` (Gaussian exact solution, served).  ``get_problem(name)``
resolves a name to a fresh problem."""

from repro_torch.pde.base import (LossTerm, PDEProblem, available,
                                  estimate_from_u_stencil, fd_stencil_points,
                                  get_problem, register, uniform_box)
from repro_torch.pde.heat import HeatProblem    # importing registers
from repro_torch.pde.hjb import HJBProblem

__all__ = ["LossTerm", "PDEProblem", "register", "get_problem", "available",
           "uniform_box", "fd_stencil_points", "estimate_from_u_stencil",
           "HJBProblem", "HeatProblem"]
