"""PDE problem interface and registry.

A ``PDEProblem`` packages what is problem-specific about a solver: the
collocation domain and sampler, the hard-constraint ansatz ``u = T(f, xt)``
that bakes the terminal condition into the network output, the pointwise
residual as a function of a ``DerivativeEstimate`` (paper Eq. 4's L_r
integrand), the composite loss as ``LossTerm``s, and an optional
closed-form exact solution.

``ansatz`` and ``residual`` broadcast over leading axes of the network
values and the estimate leaves: the stacked ZO path feeds them ``(P, ...)``
values for all P SPSA perturbations at once.

Port of ``repro.pde.base``.  Domains and coefficient families are not
ported yet, so every problem here is unconditioned (``coeff_spec`` None),
on its raw box (``domain`` None) and has no input feature map.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import stein

__all__ = ["LossTerm", "PDEProblem", "register", "get_problem", "available",
           "uniform_box", "fd_stencil_points", "estimate_from_u_stencil",
           "estimate_for_problem"]

_TERM_KINDS = ("collocation", "boundary", "data")


@dataclasses.dataclass(frozen=True)
class LossTerm:
    """One weighted term of the composite PINN loss L = Σ_k w_k·L_k.

    ``kind`` "collocation" is the PDE residual term (exactly one per
    problem; ``sample(generator, n)`` draws interior rows); "boundary" and
    "data" are pointwise matches ``mean((u(x) − target)²)`` on batches
    ``sample(generator, n) -> (x, target)``."""

    name: str
    kind: str
    weight: float = 1.0
    sample: Callable | None = None

    def __post_init__(self):
        if self.kind not in _TERM_KINDS:
            raise ValueError(f"unknown LossTerm kind {self.kind!r}; "
                             f"expected one of {_TERM_KINDS}")
        object.__setattr__(self, "weight", float(self.weight))


class PDEProblem:
    """Base class: one PDE workload of the tensor PINN stack."""

    name: str = ""
    space_dim: int = 0
    time_dependent: bool = True   # input is (x, t); False → input is x only
    has_boundary_loss: bool = False
    bc_weight: float = 1.0        # λ in L = L_r + λ·L_b (paper Eq. 4)
    has_data_loss: bool = False
    data_weight: float = 1.0
    fd_step: float = 1e-2         # recommended FD step for this problem
    residual_tol: float = 5e-2    # MSQ residual of the exact solution under
    #                               the f32 FD estimator at ``fd_step``
    coeff_spec = None             # coefficient families are not ported yet
    domain = None                 # domain normalization is not ported yet
    estimator: str = "fd"         # what PINNConfig.deriv == "auto" picks
    _term_weights: dict = {}      # per-instance overrides, set_term_weights

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

    def residual(self, est: stein.DerivativeEstimate,
                 xt: torch.Tensor) -> torch.Tensor:
        """Pointwise PDE residual (..., B) from a derivative estimate of u."""
        raise NotImplementedError(
            f"{self.name or type(self).__name__} defines no residual")

    def boundary_batch(self, generator: torch.Generator, n: int):
        """(xb, ub) boundary rows and targets, or None (no boundary term)."""
        return None

    def data_batch(self, generator: torch.Generator, n: int):
        """(x_d, u_d) observed rows and values, or None (no data term)."""
        return None

    def exact_solution(self, xt: torch.Tensor) -> torch.Tensor | None:
        """Closed-form u(xt) for validation, or None if unknown."""
        return None

    @property
    def has_exact_solution(self) -> bool:
        return type(self).exact_solution is not PDEProblem.exact_solution

    # ------------------------------------------------------ composite loss
    def loss_terms(self) -> tuple:
        """The composite loss as ``LossTerm``s: the collocation term first,
        then the boundary and data terms the problem declares, with
        ``set_term_weights`` overrides applied."""
        terms = [LossTerm("residual", "collocation", 1.0,
                          self.sample_collocation)]
        if self.has_boundary_loss:
            terms.append(LossTerm("boundary", "boundary", self.bc_weight,
                                  self.boundary_batch))
        if self.has_data_loss:
            terms.append(LossTerm("data", "data", self.data_weight,
                                  self.data_batch))
        return self._apply_term_weights(terms)

    def _apply_term_weights(self, terms) -> tuple:
        ov = self._term_weights
        if ov:
            terms = [dataclasses.replace(t, weight=ov.get(t.name, t.weight))
                     for t in terms]
        return tuple(terms)

    def set_term_weights(self, weights: dict) -> None:
        """Override term weights by name (unknown names raise); the
        overrides are this instance's and go into checkpoint meta."""
        known = {t.name for t in self.loss_terms()}
        unknown = set(weights) - known
        if unknown:
            raise ValueError(f"unknown loss term(s) {sorted(unknown)}; "
                             f"{self.name or type(self).__name__} has "
                             f"{sorted(known)}")
        self._term_weights = {**self._term_weights,
                              **{k: float(v) for k, v in weights.items()}}

    def term_weights(self) -> dict:
        """Effective ``{name: weight}`` of ``loss_terms()``."""
        return {t.name: t.weight for t in self.loss_terms()}

    def scale_estimate(self, est: stein.DerivativeEstimate
                       ) -> stein.DerivativeEstimate:
        """Fold the domain's Jacobian into a unit-box estimate: the
        identity (the same object) while ``domain`` is None."""
        if self.domain is not None:
            raise NotImplementedError(
                "domain normalization is not ported yet (ROADMAP queue A, "
                "item 9a)")
        return est


def uniform_box(generator: torch.Generator, n: int, dim: int, lo: float,
                hi: float) -> torch.Tensor:
    """Uniform float32 sample in [lo, hi]^dim, on the CPU."""
    return lo + (hi - lo) * torch.rand((n, dim), generator=generator)


def fd_stencil_points(xt: torch.Tensor, h: float,
                      n_active: int | None = None) -> torch.Tensor:
    """(2A+1, B, D) central-difference stencil
    [x, x+h·e_1, ..., x+h·e_A, x−h·e_1, ..., x−h·e_A] over the first A
    coordinates (A = D when None)."""
    B, D = xt.shape
    A = D if n_active is None else n_active
    eye = torch.eye(A, D, dtype=xt.dtype, device=xt.device) * h
    return torch.cat([xt[None], xt[None] + eye[:, None],
                      xt[None] - eye[:, None]], dim=0)


def estimate_from_u_stencil(vals: torch.Tensor, h: float
                            ) -> stein.DerivativeEstimate:
    """Assemble (u, ∇u, diag H) from u-values on the central-difference
    stencil: vals (..., 2D+1, B) → leaves u (..., B) and (..., B, D)."""
    D = (vals.shape[-2] - 1) // 2
    u0 = vals[..., 0, :]
    up, um = vals[..., 1:D + 1, :], vals[..., D + 1:, :]
    return stein.DerivativeEstimate(
        u=u0,
        grad=((up - um) / (2.0 * h)).transpose(-1, -2),
        hess_diag=((up - 2.0 * u0[..., None, :] + um)
                   / (h * h)).transpose(-1, -2))


def estimate_for_problem(problem: PDEProblem, f: Callable,
                         xt: torch.Tensor,
                         generator: torch.Generator | None = None,
                         estimator: str | None = None,
                         z: torch.Tensor | None = None
                         ) -> stein.DerivativeEstimate:
    """Derivative estimate of a callable u at rows ``xt`` under the
    problem's declared estimator (or ``estimator``), with the domain
    Jacobian folded in: "evaluate the residual the way this problem is
    trained" as one call.  ``generator`` and ``z`` (the Stein directions,
    (S, B, D)) are read by the stein estimator only."""
    deriv = problem.estimator if estimator is None else estimator
    if deriv in ("fd", "fd_fast"):
        est = stein.fd_estimate(f, xt, h=problem.fd_step,
                                n_active=problem.in_dim)
    elif deriv == "stein":
        est = stein.stein_estimate(f, xt, generator, n_active=problem.in_dim,
                                   z=z)
    elif deriv == "spectral":
        raise NotImplementedError("the spectral estimator is not ported yet "
                                  "(ROADMAP queue A, item 9a)")
    else:
        raise ValueError(f"unknown estimator {deriv!r}")
    return problem.scale_estimate(est)


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
