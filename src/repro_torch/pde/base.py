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

A problem on a non-unit box declares a ``Domain``: its samplers emit
unit-box rows, the network, the FD stencils and the spectral line grids
work on them, and ``scale_estimate`` folds the Jacobian into every
derivative estimate before the residual, which is stated in raw
coordinates, sees it.  An input feature map (``embed_features``) replaces
the row inside the network's embedding (ns-2d's Fourier features).

A coefficient-conditioned problem (``coeff_spec`` a ``CoeffSpec``) works
on augmented rows of width ``net_dim = in_dim + K``: the physical point,
then its K coefficient values in raw units.  Its samplers append a draw
per row, so the stacked evaluator, the stencils, the serving pool and the
stencil cache see coefficients as ordinary input columns that the
estimators never shift.

Port of ``repro.pde.base``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import spectral, stein

__all__ = ["CoeffSpec", "Domain", "LossTerm", "PDEProblem", "register",
           "get_problem", "available", "uniform_box", "fd_stencil_points",
           "estimate_from_u_stencil", "estimate_for_problem"]

@dataclasses.dataclass(frozen=True)
class Domain:
    """Axis-aligned box [lo, hi]^D mapped to the unit box.

    A problem that declares a ``Domain`` samples its rows in unit-box
    coordinates z = (x − lo) / (hi − lo); the PDE residual is stated in
    raw coordinates x.  The chain rule is a diagonal rescale, ∂_x = ∂_z / s
    and ∂²_x = ∂²_z / s² with s = hi − lo per axis, which
    ``PDEProblem.scale_estimate`` folds into every estimate."""

    lo: tuple
    hi: tuple

    def __post_init__(self):
        object.__setattr__(self, "lo", tuple(float(v) for v in self.lo))
        object.__setattr__(self, "hi", tuple(float(v) for v in self.hi))
        if len(self.lo) != len(self.hi):
            raise ValueError("Domain lo/hi length mismatch")
        if not self.lo:
            raise ValueError("Domain needs at least one axis")
        for a, b in zip(self.lo, self.hi):
            if not a < b:
                raise ValueError(f"Domain axis needs lo < hi, got [{a}, {b}]")

    @property
    def dim(self) -> int:
        return len(self.lo)

    @property
    def scales(self) -> np.ndarray:
        """(D,) per-axis Jacobian factors s = hi − lo of x = lo + s·z."""
        return np.asarray(self.hi, dtype=np.float32) \
            - np.asarray(self.lo, dtype=np.float32)

    @property
    def is_unit(self) -> bool:
        return all(a == 0.0 and b == 1.0 for a, b in zip(self.lo, self.hi))

    def _lo_scales(self, like: torch.Tensor) -> tuple:
        return (torch.tensor(self.lo, dtype=like.dtype, device=like.device),
                torch.tensor(self.scales, dtype=like.dtype,
                             device=like.device))

    def from_unit(self, z: torch.Tensor) -> torch.Tensor:
        """Unit-box rows (..., ≥D) → raw coordinates on the first D columns
        (trailing coefficient slots pass through untouched)."""
        lo, s = self._lo_scales(z)
        head = lo + s * z[..., :self.dim]
        return torch.cat([head, z[..., self.dim:]], dim=-1) \
            if z.shape[-1] > self.dim else head

    def to_unit(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of ``from_unit``: raw rows → unit-box coordinates."""
        lo, s = self._lo_scales(x)
        head = (x[..., :self.dim] - lo) / s
        return torch.cat([head, x[..., self.dim:]], dim=-1) \
            if x.shape[-1] > self.dim else head


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


@dataclasses.dataclass(frozen=True)
class CoeffSpec:
    """Named PDE-coefficient vector with its sampling ranges.

    Rows of a conditioned problem carry the coefficient values in
    ``names`` order after the physical point, in raw units; the network
    sees them through ``normalize`` in [0, 1].  ``dist`` is ``"uniform"``
    or ``"loguniform"`` (which needs strictly positive ranges)."""

    names: tuple
    lo: tuple
    hi: tuple
    dist: str = "uniform"

    def __post_init__(self):
        object.__setattr__(self, "names", tuple(self.names))
        object.__setattr__(self, "lo", tuple(float(v) for v in self.lo))
        object.__setattr__(self, "hi", tuple(float(v) for v in self.hi))
        if not (len(self.names) == len(self.lo) == len(self.hi)):
            raise ValueError("names/lo/hi length mismatch")
        if not self.names:
            raise ValueError("CoeffSpec needs at least one coefficient")
        if self.dist not in ("uniform", "loguniform"):
            raise ValueError(f"unknown coefficient dist {self.dist!r}")
        for nm, a, b in zip(self.names, self.lo, self.hi):
            if not a < b:
                raise ValueError(f"coefficient {nm!r}: need lo < hi, "
                                 f"got [{a}, {b}]")
            if self.dist == "loguniform" and a <= 0.0:
                raise ValueError(f"coefficient {nm!r}: loguniform needs "
                                 f"lo > 0, got {a}")

    @property
    def n(self) -> int:
        return len(self.names)

    def _bounds(self, like: torch.Tensor) -> tuple:
        return (torch.tensor(self.lo, dtype=like.dtype, device=like.device),
                torch.tensor(self.hi, dtype=like.dtype, device=like.device))

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """(n, K) float32 draws in raw units, on the generator's device."""
        u = torch.rand((n, self.n), generator=generator,
                       device=generator.device)
        lo, hi = self._bounds(u)
        if self.dist == "loguniform":
            return torch.exp(torch.log(lo) + u * (torch.log(hi)
                                                  - torch.log(lo)))
        return lo + u * (hi - lo)

    def normalize(self, c: torch.Tensor) -> torch.Tensor:
        """Raw units → [0, 1] network input slots (in log space for
        loguniform, so the network sees the sampling measure uniformly)."""
        lo, hi = self._bounds(c)
        if self.dist == "loguniform":
            return ((torch.log(c) - torch.log(lo))
                    / (torch.log(hi) - torch.log(lo)))
        return (c - lo) / (hi - lo)

    def defaults(self) -> np.ndarray:
        """(K,) mid-range coefficients (the geometric mid for
        loguniform)."""
        lo, hi = np.asarray(self.lo), np.asarray(self.hi)
        if self.dist == "loguniform":
            return np.sqrt(lo * hi)
        return 0.5 * (lo + hi)

    def check_in_range(self, c, rtol: float = 1e-6) -> None:
        """Raise ValueError on a wrong-arity or out-of-range coefficient
        vector (numpy; the serving boundary, where extrapolating outside
        the trained range must be an error, not a quietly wrong answer)."""
        c = np.asarray(c, dtype=np.float64).reshape(-1)
        if c.shape[0] != self.n:
            raise ValueError(
                f"expected {self.n} coefficient(s) ({', '.join(self.names)}),"
                f" got {c.shape[0]}")
        lo, hi = np.asarray(self.lo), np.asarray(self.hi)
        slack = rtol * (hi - lo)
        bad = (c < lo - slack) | (c > hi + slack)
        if bad.any():
            raise ValueError("; ".join(
                f"{nm}={v:g} outside trained range [{a:g}, {b:g}]"
                for nm, v, a, b, m in zip(self.names, c, lo, hi, bad) if m))

    def with_ranges(self, overrides: dict, dist: str | None = None
                    ) -> "CoeffSpec":
        """A new spec with ``{name: (lo, hi)}`` overrides (and ``dist``)."""
        unknown = set(overrides) - set(self.names)
        if unknown:
            raise ValueError(f"unknown coefficient(s) {sorted(unknown)}; "
                             f"this family has {list(self.names)}")
        lo, hi = list(self.lo), list(self.hi)
        for nm, (a, b) in overrides.items():
            i = self.names.index(nm)
            lo[i], hi[i] = float(a), float(b)
        return CoeffSpec(self.names, tuple(lo), tuple(hi),
                         self.dist if dist is None else dist)

    def to_meta(self) -> dict:
        return {"names": list(self.names), "lo": list(self.lo),
                "hi": list(self.hi), "dist": self.dist}

    @staticmethod
    def from_meta(meta: dict) -> "CoeffSpec":
        return CoeffSpec(tuple(meta["names"]), tuple(meta["lo"]),
                         tuple(meta["hi"]), meta.get("dist", "uniform"))


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
    coeff_spec: CoeffSpec | None = None  # set: coefficient-conditioned
    domain: Domain | None = None  # set: the samplers emit unit-box rows and
    #                               scale_estimate folds in the Jacobian
    _term_weights: dict = {}      # per-instance overrides, set_term_weights
    # the estimator PINNConfig.deriv == "auto" picks, and the spectral
    # estimator's line grids: ``spectral_points`` points a line spanning
    # ``spectral_extent`` in each active coordinate, made FFT-ready by
    # ``spectral_periodization`` ("window", "periodic" or a per-axis tuple;
    # repro_torch.core.spectral)
    estimator: str = "fd"         # "fd" | "stein" | "spectral"
    spectral_points: int = 16
    spectral_extent: float = 1.0
    spectral_periodization: str | tuple = "window"

    @property
    def in_dim(self) -> int:
        """Physical input width (x [, t])."""
        return self.space_dim + (1 if self.time_dependent else 0)

    @property
    def n_coeffs(self) -> int:
        return 0 if self.coeff_spec is None else self.coeff_spec.n

    @property
    def net_dim(self) -> int:
        """Row width the network consumes (in_dim + n_coeffs): every
        point-shaped array (collocation batches, stencils, serving slots,
        cache keys) has rows this wide."""
        return self.in_dim + self.n_coeffs

    def split_coeffs(self, xt: torch.Tensor) -> tuple:
        """(..., net_dim) rows → ((..., in_dim) points, (..., K) coeffs)."""
        return xt[..., :self.in_dim], xt[..., self.in_dim:self.net_dim]

    def attach_coeffs(self, pts: torch.Tensor, coeffs) -> torch.Tensor:
        """(n, in_dim) points and one (K,) coefficient vector → (n,
        net_dim) augmented rows (the serving path: one scenario a
        request); unconditioned problems return ``pts``."""
        if self.coeff_spec is None:
            return pts
        c = torch.as_tensor(coeffs, dtype=pts.dtype,
                            device=pts.device).reshape(-1)
        return torch.cat([pts, c.expand(pts.shape[0], self.n_coeffs)],
                         dim=-1)

    def _sample_with_coeffs(self, generator: torch.Generator, n: int,
                            point_sampler) -> torch.Tensor:
        """The samplers' shared plumbing: ``point_sampler(generator)``'s
        points, then, for a conditioned problem, a coefficient draw a row
        from the same generator (unconditioned problems draw the points
        alone, as before)."""
        pts = point_sampler(generator)
        if self.coeff_spec is None:
            return pts
        return torch.cat([pts, self.coeff_spec.sample(generator, n)
                          .to(pts.dtype)], dim=-1)

    def embed_features(self, xt: torch.Tensor):
        """Optional input feature map (..., net_dim) → (..., feature_dim),
        applied inside the network's embedding before the padding (e.g.
        Fourier features that make the network exactly periodic).  A
        problem with one cannot take ``fd_fast`` (its rank-1 layer-1 trick
        needs an affine embedding): ``core.pinn`` runs plain ``fd``.  None
        (the default) keeps the zero-padded row."""
        return None

    @property
    def feature_dim(self) -> int:
        """Network input width after ``embed_features`` (net_dim without a
        feature map)."""
        return self.net_dim

    @property
    def has_feature_map(self) -> bool:
        return type(self).embed_features is not PDEProblem.embed_features

    def spectral_carrier(self, rows: torch.Tensor, anchors: torch.Tensor):
        """Closed-form additive ansatz part β with its exact derivatives,
        or None.  Line segments of the spectral estimator can cross kinks of
        the ansatz (HJB's ‖x‖₁ at x_i = 0), which leave O(1) Gibbs error in
        the FFT Hessian.  A problem whose ansatz is u = s + β returns
        ``(β(rows), ∇β(anchors), diag∇²β(anchors))``, shapes ``(R,)``,
        ``(B, A)``, ``(B, A)`` for ``rows`` (R, net_dim) and ``anchors``
        (B, net_dim), A = in_dim: the FFT then sees only u − β.  None (the
        default) differentiates u itself."""
        return None

    def sample_collocation(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """(n, net_dim) interior rows (float32, on the CPU)."""
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
        """Fold the ``Domain`` Jacobian into a unit-box estimate: ∂_x =
        ∂_z / s, ∂²_x = ∂²_z / s² per active axis.  With no domain, or the
        unit box, the estimate comes back unchanged: the same object."""
        if self.domain is None or self.domain.is_unit:
            return est
        g = est.grad
        s = torch.tensor(self.domain.scales[:g.shape[-1]], dtype=g.dtype,
                         device=g.device)
        return stein.DerivativeEstimate(u=est.u, grad=g / s,
                                        hess_diag=est.hess_diag / (s * s))


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
    trained" as one call.  ``f(rows)`` takes any number of rows (the
    spectral estimator feeds it line rows).  ``generator`` and ``z`` (the
    Stein directions, (S, B, D)) are read by the stein estimator only."""
    deriv = problem.estimator if estimator is None else estimator
    if deriv == "spectral":
        est = spectral.spectral_estimate(
            f, xt, points=problem.spectral_points,
            extent=problem.spectral_extent,
            periodization=problem.spectral_periodization,
            n_active=problem.in_dim, carrier=problem.spectral_carrier)
    elif deriv in ("fd", "fd_fast"):
        est = stein.fd_estimate(f, xt, h=problem.fd_step,
                                n_active=problem.in_dim)
    elif deriv == "stein":
        est = stein.stein_estimate(f, xt, generator, n_active=problem.in_dim,
                                   z=z)
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
