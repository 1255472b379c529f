"""PDE problem registry, serving slice: ``hjb-20d`` / ``hjb-10d`` (the
paper's HJB benchmark) and ``heat-10d`` / ``heat-20d`` (Gaussian exact
solution).  ``get_problem(name)`` resolves a name to a fresh problem."""

from repro_torch.pde.base import (PDEProblem, available, get_problem,
                                  register, uniform_box)
from repro_torch.pde.heat import HeatProblem    # importing registers
from repro_torch.pde.hjb import HJBProblem

__all__ = ["PDEProblem", "register", "get_problem", "available",
           "uniform_box", "HJBProblem", "HeatProblem"]
