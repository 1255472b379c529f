"""PDE problem interface and registry — the serving surface.

A ``PDEProblem`` packages what is problem-specific about a solver: the
collocation domain and sampler, the hard-constraint ansatz ``u = T(f, xt)``
that bakes the terminal condition into the network output, and an optional
closed-form exact solution.

Port of ``repro.pde.base`` for serving: residuals, loss terms, domains and
coefficient families belong to later slices, so every problem here is
unconditioned (``coeff_spec`` None) and has no input feature map.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["PDEProblem", "register", "get_problem", "available",
           "uniform_box"]


class PDEProblem:
    """Base class: one PDE workload of the tensor PINN stack."""

    name: str = ""
    space_dim: int = 0
    time_dependent: bool = True   # input is (x, t); False → input is x only
    coeff_spec = None             # coefficient families are not ported yet

    @property
    def in_dim(self) -> int:
        """Physical input width (x [, t])."""
        return self.space_dim + (1 if self.time_dependent else 0)

    @property
    def n_coeffs(self) -> int:
        return 0

    @property
    def net_dim(self) -> int:
        """Row width the network consumes (in_dim + n_coeffs)."""
        return self.in_dim + self.n_coeffs

    @property
    def has_feature_map(self) -> bool:
        return False

    def sample_collocation(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """(n, in_dim) interior points (float32, on the CPU)."""
        raise NotImplementedError

    def ansatz(self, f: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
        """Hard-constraint transform u = T(f, xt); ``f`` broadcasts against
        ``xt[..., 0]``."""
        raise NotImplementedError

    def exact_solution(self, xt: torch.Tensor) -> torch.Tensor | None:
        """Closed-form u(xt) for validation, or None if unknown."""
        return None


def uniform_box(generator: torch.Generator, n: int, dim: int, lo: float,
                hi: float) -> torch.Tensor:
    """Uniform float32 sample in [lo, hi]^dim, on the CPU."""
    return lo + (hi - lo) * torch.rand((n, dim), generator=generator)


_REGISTRY: dict[str, Callable[[], PDEProblem]] = {}


def register(name: str):
    """Decorator: register a zero-arg factory under ``name``."""
    def deco(factory: Callable[[], PDEProblem]):
        if name in _REGISTRY:
            raise ValueError(f"PDE {name!r} already registered")
        _REGISTRY[name] = factory
        return factory
    return deco


def get_problem(name: str) -> PDEProblem:
    """Instantiate the registered problem ``name`` (fresh instance)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown PDE {name!r}; known: {sorted(_REGISTRY)}")
    prob = _REGISTRY[name]()
    if not prob.name:
        prob.name = name
    return prob


def available() -> tuple:
    """Registered problem names, sorted."""
    return tuple(sorted(_REGISTRY))
