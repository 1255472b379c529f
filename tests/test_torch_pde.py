"""The port's PDE problems (heat, Black–Scholes, HJB, Helmholtz with its
boundary term, the four coefficient-conditioned families), its Stein
estimator, ``estimate_for_problem``, the Stein and boundary paths of the
loss engine and the trainer's term weights, against the JAX package: the
counterpart of ``tests/test_pde.py`` for these problems.

Inputs are the JAX side's arrays (collocation rows, Gaussian directions,
params) handed over as numpy.  Tolerances:

* ansatz, residual and exact solution: ``rtol 1e-6`` (the same f32
  elementwise ops; sums over D and ``exp`` from two libraries), and for
  the ansatz and the residual, whose terms cancel, ``atol 1e-6·max|·|``;
* the FD floors: each package's exact solution under its own FD estimator
  sits below ``residual_tol``; the mean r² of the two packages agrees to
  ``rtol 1e-3`` when both differentiate the same function (a float64 numpy
  one).  Each package's own exact solution differs from the other's by up
  to 5.4e-7 relative (``exp`` and the sum order), which the 1/h² = 1e4 of
  the second difference turns into 3–21% of the floor;
* Stein's leaves: u exact, grad and hess within ``1e-4·max|leaf|`` (1/σ²
  = 400 amplifies the f32 rounding of the stencil sums; the worst measured
  case on these inputs is ``STEIN_LEAF_WORST``);
* Stein losses: ``rtol 1e-4`` (measured ≤ 8e-6 on these inputs);
* stacked stencil u and a boundary term's u: ``max|Δ| ≤ 1e-6·max|u|``;
  FD losses ``rtol 1e-1`` over ``LOSS_BATCH`` points (the FD floor,
  DESIGN.md §Perf);
* helmholtz-2d's composite loss: ``rtol 1e-5`` against L_r + λ·MSE of the
  same package, and against JAX's ``HELM_LOSS_RTOL`` (its residual is
  scaled by 1/|k² − 5π²|, so the f32 FD rounding of u, amplified by 1/h²,
  enters the loss only at the ``HELM_LOSS_RTOL`` level).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pde as jpde
from repro.core import pinn as jpinn
from repro.core import stein as jstein
from repro.core.photonic import NoiseModel as JNoise
from repro_torch import interop
from repro_torch import pde as tpde
from repro_torch.core import pinn as tpinn
from repro_torch.core import stein as tstein
from repro_torch.launch import train
from test_torch_pinn import _np_tree, _port_model, share_cores

PDES = ("hjb-10d", "hjb-20d", "heat-10d", "heat-20d", "black-scholes-100d",
        "helmholtz-2d", "heat-10d-kappa", "hjb-10d-lam",
        "black-scholes-8d-rs", "black-scholes-100d-rs")
STEIN_LEAF_WORST = 5e-5          # measured: 4.5e-5 (heat-20d hess_diag)
LOSS_BATCH = 96


def _rows(name, n=64, seed=0):
    """JAX's collocation rows of ``name`` as numpy."""
    return np.asarray(jpde.get_problem(name).sample_collocation(
        jax.random.PRNGKey(seed), n))


def _relmax(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


# ------------------------------------------------------------------ registry

@pytest.mark.parametrize("name", PDES)
def test_registry_surface_matches_jax(name):
    jp, tp = jpde.get_problem(name), tpde.get_problem(name)
    assert name in tpde.available() and tp.name == name
    assert tp.in_dim == tp.space_dim + int(tp.time_dependent) == jp.in_dim
    assert tp.net_dim == jp.net_dim and tp.n_coeffs == jp.n_coeffs
    assert (tp.coeff_spec is None) == (jp.coeff_spec is None)
    if tp.coeff_spec is not None:
        assert tp.coeff_spec.to_meta() == jp.coeff_spec.to_meta()
    for attr in ("space_dim", "time_dependent", "has_boundary_loss",
                 "bc_weight", "fd_step", "residual_tol", "estimator",
                 "margin", "has_exact_solution"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    if name.startswith("black-scholes"):
        assert (tp.sigma, tp.r) == (jp.sigma, jp.r) == (0.4, 0.05)
    if name == "helmholtz-2d":
        assert (tp.k, tp.a, tp.scale) == (jp.k, jp.a, jp.scale)
        assert not tp.time_dependent and tp.residual_tol == 1e-6
    want = ({"residual": 1.0, "boundary": 1.0} if tp.has_boundary_loss
            else {"residual": 1.0})
    assert tp.term_weights() == jp.term_weights() == want
    assert [(t.name, t.kind) for t in tp.loss_terms()] == \
        [(t.name, t.kind) for t in jp.loss_terms()]


def test_heat_floor_is_the_references():
    assert tpde.get_problem("heat-20d").residual_tol == 1e-2
    assert tpde.HeatProblem(space_dim=3).residual_tol == 1e-2


@pytest.mark.parametrize("name", PDES)
def test_collocation_shapes_and_bounds(name):
    tp = tpde.get_problem(name)
    pts = tp.sample_collocation(torch.Generator().manual_seed(3), 257)
    assert tuple(pts.shape) == (257, tp.net_dim) and pts.dtype == torch.float32
    if tp.coeff_spec is not None:       # a draw a row, inside the ranges
        c = pts[:, tp.in_dim:].numpy()
        assert (c >= np.float32(tp.coeff_spec.lo)).all()
        assert (c <= np.float32(tp.coeff_spec.hi)).all()
        assert len(np.unique(c[:, 0])) == 257
    m = tp.margin
    D = tp.space_dim
    x = pts[:, :D]
    lo = 0.5 + m if name.startswith("black-scholes") else m
    assert float(x.min()) >= lo and float(x.max()) <= lo + 1 - 2 * m
    if tp.time_dependent:
        t = pts[:, D]
        assert float(t.min()) >= m and float(t.max()) <= 1 - m
    # and JAX's rows lie in the same box
    jx = _rows(name, 257)
    assert jx.min(0)[:D].min() >= lo and jx.max(0)[:D].max() <= lo + 1 - 2 * m


@pytest.mark.parametrize("name", PDES)
def test_ansatz_residual_and_exact_solution_match_jax(name):
    """On JAX's collocation rows: ``ansatz`` of a given f, ``residual`` of
    a given estimate and ``exact_solution``."""
    jp, tp = jpde.get_problem(name), tpde.get_problem(name)
    xt = _rows(name)
    B, A = xt.shape[0], tp.in_dim
    rs = np.random.RandomState(len(name))
    f = rs.standard_normal(B).astype(np.float32)
    u, grad, hess = (rs.standard_normal(s).astype(np.float32)
                     for s in ((B,), (B, A), (B, A)))
    want = np.asarray(jp.ansatz(jnp.asarray(f), jnp.asarray(xt)))
    np.testing.assert_allclose(
        tp.ansatz(torch.tensor(f), torch.tensor(xt)).numpy(), want,
        rtol=1e-6, atol=1e-6 * np.abs(want).max())
    want = np.asarray(jp.residual(
        jstein.DerivativeEstimate(jnp.asarray(u), jnp.asarray(grad),
                                  jnp.asarray(hess)), jnp.asarray(xt)))
    got = tp.residual(tstein.DerivativeEstimate(
        torch.tensor(u), torch.tensor(grad), torch.tensor(hess)),
        torch.tensor(xt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(
        want).max())
    np.testing.assert_allclose(
        tp.exact_solution(torch.tensor(xt)).numpy(),
        np.asarray(jp.exact_solution(jnp.asarray(xt))), rtol=1e-6)


def _exact_f64(jp):
    """The problem's exact solution in float64 numpy, rounded to f32: one
    function both packages can differentiate."""
    D = jp.space_dim

    def f(rows):
        r = np.asarray(rows, dtype=np.float64)
        x, t = r[..., :D], r[..., min(D, r.shape[-1] - 1)]
        c = r[..., jp.in_dim:]           # a conditioned row's coefficients
        if jp.name.startswith("helmholtz"):
            a1, a2 = jp.a
            u = np.sin(a1 * np.pi * x[..., 0]) * np.sin(a2 * np.pi * x[..., 1])
        elif jp.name.startswith("heat"):
            kappa = c[..., 0] if jp.n_coeffs else 1.0
            tau = jp.s + kappa * (1.0 - t)
            q = np.sum((x - jp.center) ** 2, axis=-1)
            u = (jp.s / tau) ** (D / 2.0) * np.exp(-q / (4.0 * tau))
        elif jp.name.startswith("black-scholes"):
            rate, sigma = ((c[..., 0], c[..., 1]) if jp.n_coeffs
                           else (jp.r, jp.sigma))
            u = np.exp((rate + sigma ** 2) * (1.0 - t)) \
                * np.sum(x * x, axis=-1) / D
        else:
            slope = 2.0 - c[..., 0] * D if jp.n_coeffs else 1.0
            u = np.sum(np.abs(x), axis=-1) + slope * (1.0 - t)
        return u.astype(np.float32)
    return f


@pytest.mark.parametrize("name", PDES)
def test_exact_solution_floors_through_estimate_for_problem(name):
    """The declared estimator and FD, each package on its own exact
    solution, below ``residual_tol``; on one shared function the two
    packages' mean r² agree to rtol 1e-3."""
    jp, tp = jpde.get_problem(name), tpde.get_problem(name)
    xt = _rows(name)
    tx = torch.tensor(xt)
    for est_name in (None, "fd"):
        est = tpde.estimate_for_problem(tp, tp.exact_solution, tx,
                                        estimator=est_name)
        r2 = float(torch.mean(tp.residual(est, tx) ** 2))
        assert r2 < tp.residual_tol, (name, est_name, r2)
    f = _exact_f64(jp)
    jest = jpde.estimate_for_problem(
        jp, lambda r: jnp.asarray(f(r)), jnp.asarray(xt), estimator="fd")
    want = float(jnp.mean(jp.residual(jest, jnp.asarray(xt)) ** 2))
    test = tpde.estimate_for_problem(
        tp, lambda r: torch.tensor(f(r.numpy())), tx, estimator="fd")
    got = float(torch.mean(tp.residual(test, tx) ** 2))
    assert got < tp.residual_tol
    assert got == pytest.approx(want, rel=1e-3)


def test_estimate_for_problem_dispatch():
    tp = tpde.get_problem("heat-10d")
    xt = torch.tensor(_rows("heat-10d", 8))
    # spectral is ported (held to JAX in tests/test_torch_spectral.py)
    est = tpde.estimate_for_problem(tp, tp.exact_solution, xt,
                                    estimator="spectral")
    assert tuple(est.grad.shape) == tuple(est.hess_diag.shape) == (8, 11)
    assert torch.equal(est.u, tp.exact_solution(xt))
    with pytest.raises(ValueError, match="unknown estimator"):
        tpde.estimate_for_problem(tp, tp.exact_solution, xt, estimator="x")
    with pytest.raises(ValueError, match="generator"):
        tpde.estimate_for_problem(tp, tp.exact_solution, xt,
                                  estimator="stein")
    a = tpde.estimate_for_problem(tp, tp.exact_solution, xt,
                                  torch.Generator().manual_seed(5), "stein")
    b = tpde.estimate_for_problem(tp, tp.exact_solution, xt,
                                  torch.Generator().manual_seed(5), "stein")
    assert torch.equal(a.hess_diag, b.hess_diag)
    assert tuple(a.grad.shape) == (8, tp.in_dim)


def test_terminal_condition_at_t1():
    """The ansatz bakes u(x, 1) in: at t = 1 it equals the exact solution
    whatever f is (the time-dependent problems)."""
    for name in PDES:
        tp = tpde.get_problem(name)
        if not tp.time_dependent:
            continue
        xt = tp.sample_collocation(torch.Generator().manual_seed(0), 9)
        xt[:, tp.space_dim] = 1.0
        f = torch.randn(9, generator=torch.Generator().manual_seed(1))
        np.testing.assert_allclose(tp.ansatz(f, xt).numpy(),
                                   tp.exact_solution(xt).numpy(),
                                   atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------- Stein

@pytest.mark.parametrize("name,n_active", [("heat-10d", None),
                                           ("heat-20d", None),
                                           ("black-scholes-100d", None),
                                           ("heat-10d", 7)])
def test_stein_estimate_matches_jax_on_its_draws(name, n_active):
    """``stein_estimate`` handed JAX's ``jax.random.normal(key, (S, B,
    D))`` as z, on one shared function: u exact, grad and hess within
    1e-4·max|leaf|; with ``n_active`` the leaves are (B, A) and the
    dropped directions are zero."""
    jp, tp = jpde.get_problem(name), tpde.get_problem(name)
    xt = _rows(name, 16)
    B, D = xt.shape
    key = jax.random.PRNGKey(1)
    z = np.asarray(jax.random.normal(key, (32, B, D)))
    f = _exact_f64(jp)
    want = jstein.stein_estimate(lambda r: jnp.asarray(f(r)), jnp.asarray(xt),
                                 key, n_active=n_active)
    got = tstein.stein_estimate(lambda r: torch.tensor(f(r.numpy())),
                                torch.tensor(xt), z=torch.tensor(z),
                                n_active=n_active)
    A = D if n_active is None else n_active
    assert tuple(got.grad.shape) == tuple(got.hess_diag.shape) == (B, A)
    np.testing.assert_array_equal(got.u.numpy(), np.asarray(want.u))
    for leaf in ("grad", "hess_diag"):
        err = _relmax(getattr(got, leaf), getattr(want, leaf))
        assert err <= 1e-4, (leaf, err)
        assert err <= STEIN_LEAF_WORST, (leaf, err)


def test_stein_directions_zero_the_inactive_coordinates():
    x = torch.zeros(3, 6)
    z = tstein.stein_directions(x, torch.Generator().manual_seed(0), 4, 4)
    assert tuple(z.shape) == (4, 3, 6)
    assert torch.all(z[..., 4:] == 0) and torch.all(z[..., :4] != 0)
    pts = tstein.stein_stencil_points(x, z, 0.5)
    assert tuple(pts.shape) == (9, 3, 6)
    assert torch.equal(pts[1:5], 0.5 * z) and torch.equal(pts[5:], -0.5 * z)
    stacked = tstein.stein_directions(x, torch.Generator().manual_seed(0), 4,
                                      lead=(2,))
    assert tuple(tstein.stein_stencil_points(x, stacked, 0.5).shape) == \
        (2, 9, 3, 6)


def _stein_models(name, mode="tt", samples=4):
    cfg = jpinn.PINNConfig(hidden=16, mode=mode, tt_rank=2, tt_L=2, pde=name,
                           deriv="stein", stein_samples=samples,
                           noise=JNoise(enabled=mode == "tonn"))
    jm = jpinn.TensorPinn(cfg)
    return cfg, jm, _port_model(cfg)


@pytest.mark.parametrize("name", ["hjb-20d", "heat-20d"])
def test_stein_residual_loss_matches_jax_with_the_same_key(name):
    cfg, jm, tm = _stein_models(name)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    xt = _rows(name, 8, seed=1)
    key = jax.random.PRNGKey(7)
    want = float(jax.jit(lambda p, x, k: jpinn.residual_loss(
        jm, p, x, key=k))(params, jnp.asarray(xt), key))
    z = np.asarray(jax.random.normal(key, (cfg.stein_samples, *xt.shape)))
    tp = interop.params_from_numpy(_np_tree(params), "cpu")
    got = float(tpinn.residual_loss(tm, tp, torch.tensor(xt),
                                    z=torch.tensor(z)))
    assert got == pytest.approx(want, rel=1e-4)
    with pytest.raises(ValueError, match="generator"):
        tpinn.residual_loss(tm, tp, torch.tensor(xt))
    per = tpinn.per_term_losses(tm, tp, torch.tensor(xt), z=torch.tensor(z))
    assert float(per["residual"]) == got


@pytest.mark.parametrize("mode", ["tt", "tonn"])
def test_stacked_stein_gives_each_entry_its_own_directions(mode):
    """The counterpart of ``test_stacked_stein_fallback_splits_key_per_
    perturbation``: identical stacked params give P distinct losses, entry i
    equals the scalar loss with ``z[i]``, and with the z of
    ``jax.random.split(key, P)[i]`` the stack equals JAX's."""
    cfg, jm, tm = _stein_models("hjb-20d", mode)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    hw = jm.sample_noise(jax.random.fold_in(jax.random.PRNGKey(0), 99))
    P = 3
    xt = _rows("hjb-20d", 8, seed=1)
    key = jax.random.PRNGKey(7)
    stacked = jax.tree.map(lambda p: jnp.stack([p] * P), params)
    want = np.asarray(jax.jit(lambda s, x, h, k: jpinn.residual_losses_stacked(
        jm, s, x, h, key=k))(stacked, jnp.asarray(xt), hw, key))
    z = np.stack([np.asarray(jax.random.normal(k, (cfg.stein_samples,
                                                   *xt.shape)))
                  for k in jax.random.split(key, P)])
    tparams = interop.params_from_numpy(_np_tree(params), "cpu")
    tstacked = interop.params_from_numpy(_np_tree(stacked), "cpu")
    noise = interop.noise_from_numpy(_np_tree(hw), "cpu")
    got = tpinn.residual_losses_stacked(tm, tstacked, torch.tensor(xt),
                                        noise, z=torch.tensor(z))
    assert len(set(got.tolist())) == P
    for i in range(P):
        one = tpinn.residual_loss(tm, tparams, torch.tensor(xt), noise,
                                  z=torch.tensor(z[i]))
        assert float(got[i]) == pytest.approx(float(one), rel=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    # drawn from a generator: distinct entries, reproducible
    g = [tpinn.residual_losses_stacked(
        tm, tstacked, torch.tensor(xt), noise,
        generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(g[0], g[1]) and len(set(g[0].tolist())) == P


def test_stein_u_stacked_feeds_layer0_per_entry(monkeypatch):
    """The stacked Stein stencil runs two ``tt_linear_batched`` calls, both
    on per-entry rows (P, (2S+1)·B, N), and its u equals each entry's own
    single forward."""
    cfg, jm, tm = _stein_models("heat-20d")
    tparams = tm.init(torch.Generator().manual_seed(0))
    P, S, B = 3, 4, 5
    stacked = {k: torch.stack([v] * P) if not isinstance(v, list)
               else [torch.stack([c] * P) for c in v]
               for k, v in tparams.items()}
    xt = tm.problem.sample_collocation(torch.Generator().manual_seed(1), B)
    z = torch.randn((P, S, B, tm.in_dim),
                    generator=torch.Generator().manual_seed(2))
    seen = []
    real = tpinn.ops.tt_linear_batched

    def spy(x, cores, spec, quant=None, shared_x=None):
        seen.append(tuple(x.shape))
        return real(x, cores, spec, quant, shared_x)

    monkeypatch.setattr(tpinn.ops, "tt_linear_batched", spy)
    u = tm.stein_u_stacked(stacked, xt, z, cfg.stein_sigma)
    R = (2 * S + 1) * B
    assert seen == [(P, R, tm.in_pad), (P, R, cfg.hidden)]
    assert tuple(u.shape) == (P, 2 * S + 1, B)
    for i in range(P):
        pts = tstein.stein_stencil_points(xt, z[i], cfg.stein_sigma)
        one = tm.u(tparams, pts.reshape(-1, tm.in_dim)).reshape(2 * S + 1, B)
        np.testing.assert_allclose(u[i].numpy(), one.numpy(), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------- stacked FD against JAX

# label -> (pde, mode, noise); hidden 16, tt_L 2, P 3
FD_CASES = {"heat20-tt": ("heat-20d", "tt", False),
            "heat20-tonn-noise": ("heat-20d", "tonn", True),
            "bs100-tt": ("black-scholes-100d", "tt", False),
            "bs100-tonn-noise": ("black-scholes-100d", "tonn", True),
            "helm-tt": ("helmholtz-2d", "tt", False),
            "helm-tonn-noise": ("helmholtz-2d", "tonn", True),
            "bs100rs-tonn-noise": ("black-scholes-100d-rs", "tonn", True),
            "heat10kappa-tt": ("heat-10d-kappa", "tt", False)}
BOUNDARY_ROWS = 24      # the trainer's max(LOSS_BATCH // 4, 8)


def _fd_setup(label, batch):
    """JAX's model, params and chip noise, a perturbation stack around the
    params (ξ from numpy) and JAX's collocation rows, as numpy."""
    name, mode, noise = FD_CASES[label]
    cfg = jpinn.PINNConfig(hidden=16, mode=mode, tt_rank=2, tt_L=2, pde=name,
                           deriv="fd_fast", noise=JNoise(enabled=noise))
    jm = jpinn.TensorPinn(cfg)
    key = jax.random.PRNGKey(len(label))
    params = _np_tree(jax.jit(jm.init)(key))
    hw = _np_tree(jm.sample_noise(jax.random.fold_in(key, 99)))
    rs = np.random.RandomState(len(label))
    mask = jm.trainable_mask(params)
    stacked = jax.tree.map(
        lambda p, m: np.stack([p] + [
            (p + 0.01 * m * rs.standard_normal(p.shape)).astype(np.float32)
            for _ in range(2)]), params, mask)
    return cfg, jm, stacked, hw, _rows(name, batch, 2)


def _u_scale(tm, stacked, want):
    """What u's f32 rounding is relative to: max|u|, or, where the ansatz
    is the identity (helmholtz-2d: u = f, no offset such as hjb's ‖x‖₁),
    the largest Σ_h |w2_h| of the stack, which bounds the head's terms
    (|sin| ≤ 1): a network output of 0.04 is a sum of terms up to ~1,
    rounded at their scale (measured: 1.2e-7 absolute, 3e-6 of max|u|)."""
    want = np.abs(np.asarray(want)).max()
    if tm.problem.name != "helmholtz-2d":
        return want
    return max(want, float(np.abs(np.asarray(stacked["w2"])).sum(-1).max()))


def _boundary(name, n=BOUNDARY_ROWS, seed=3):
    """JAX's boundary rows and targets of ``name`` as numpy, or None."""
    jp = jpde.get_problem(name)
    if not jp.has_boundary_loss:
        return None
    return tuple(np.asarray(a) for a in jp.boundary_batch(
        jax.random.PRNGKey(seed), n))


@pytest.mark.parametrize("label", sorted(FD_CASES))
def test_stacked_fd_stencil_and_losses_match_jax(label):
    """From JAX's params: the stacked stencil u, and a boundary term's u
    where the problem has one, against JAX's within 1e-6·max|u|, and the
    (P,) losses with the boundary term at the FD floor (rtol 1e-1 over
    ``LOSS_BATCH`` points).  The ±1 diag buffers stay unperturbed."""
    cfg, jm, stacked, hw, xt = _fd_setup(label, LOSS_BATCH)
    bc = _boundary(cfg.pde)
    jtb = None if bc is None else {"boundary": tuple(map(jnp.asarray, bc))}

    @jax.jit
    def reference(s, h, x):
        prep = jm.prepare_params_stacked(s, h)
        ub = (None if jtb is None
              else jm.u_stacked(prep, jtb["boundary"][0]))
        return (jm.fd_u_stencil_stacked(prep, x, jm.fd_step), ub,
                jpinn.residual_losses_stacked(jm, s, x, h, term_batches=jtb))

    want_u, want_ub, want_l = reference(stacked, hw, jnp.asarray(xt))
    tm = _port_model(cfg)
    noise = interop.noise_from_numpy(hw, "cpu")
    tstacked = interop.params_from_numpy(stacked, "cpu")
    tprep = tm.prepare_params_stacked(tstacked, noise)
    got_u = tm.fd_u_stencil_stacked(tprep, torch.tensor(xt), tm.fd_step)
    assert tuple(got_u.shape) == (3, 2 * tm.in_dim + 1, LOSS_BATCH)
    scale = _u_scale(tm, stacked, want_u)
    assert np.abs(got_u.numpy() - want_u).max() <= 1e-6 * scale
    ttb = None
    if bc is not None:
        ttb = {"boundary": tuple(map(torch.tensor, bc))}
        got_ub = tm.u_stacked(tprep, ttb["boundary"][0])
        assert tuple(got_ub.shape) == (3, BOUNDARY_ROWS)
        assert np.abs(got_ub.numpy() - want_ub).max() <= \
            1e-6 * _u_scale(tm, stacked, want_ub)
    got_l = tpinn.residual_losses_stacked(tm, tstacked, torch.tensor(xt),
                                          noise, term_batches=ttb)
    assert torch.isfinite(got_l).all()
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-1)


# ----------------------------------------------------------------------- CLI

@pytest.mark.parametrize("name", ["heat-10d", "black-scholes-100d"])
def test_cli_trains_the_new_problems(name):
    res = train.main(["--arch", "tensor-pinn", "--pde", name, "--reduced",
                      "--hidden", "16", "--pinn-noise", "--device", "cpu",
                      "--steps", "3", "--batch", "4", "--zo-samples", "3",
                      "--log-every", "100"])
    assert res.model.problem.name == name and len(res.losses) == 3
    assert np.isfinite(res.losses).all() and np.isfinite(res.val_mse)


def test_cli_refuses_stein_naming_the_reference_fault():
    with pytest.raises(SystemExit, match="passes no PRNG key"):
        train.main(["--arch", "tensor-pinn", "--pde", "heat-10d", "--reduced",
                    "--device", "cpu", "--estimator", "stein"])


# ------------------------------------------------ helmholtz-2d's boundary term

def test_boundary_batch_on_the_boundary_with_zero_targets():
    """n = 128 points, every one on ∂[0,1]² (one coordinate exactly 0 or
    1, the other in [0, 1)), targets zero, all 4 sides drawn; the same
    generator state gives the same batch, and the exact solution vanishes
    there."""
    tp = tpde.get_problem("helmholtz-2d")
    xb, ub = tp.boundary_batch(torch.Generator().manual_seed(0), 128)
    assert tuple(xb.shape) == (128, 2) and tuple(ub.shape) == (128,)
    assert xb.dtype == ub.dtype == torch.float32
    assert torch.all(ub == 0)
    on_edge = (xb == 0) | (xb == 1)
    assert torch.all(on_edge.any(dim=-1))
    assert float(xb.min()) >= 0.0 and float(xb.max()) <= 1.0
    sides = {(ax, int(v)) for row in xb.tolist()
             for ax, v in enumerate(row) if v in (0.0, 1.0)}
    assert sides == {(0, 0), (0, 1), (1, 0), (1, 1)}
    again, _ = tp.boundary_batch(torch.Generator().manual_seed(0), 128)
    assert torch.equal(again, xb)
    np.testing.assert_allclose(tp.exact_solution(xb).numpy(), 0.0, atol=1e-6)


HELM_LOSS_RTOL = 1e-4   # measured ≤ 1.1e-5 (the stacked cases above)


def _helm_setup(mode="tt", noise=False, batch=16):
    cfg = jpinn.PINNConfig(hidden=16, mode=mode, tt_rank=2, tt_L=2,
                           pde="helmholtz-2d", deriv="fd_fast",
                           noise=JNoise(enabled=noise))
    jm = jpinn.TensorPinn(cfg)
    key = jax.random.PRNGKey(4)
    params = _np_tree(jax.jit(jm.init)(key))
    hw = _np_tree(jm.sample_noise(jax.random.fold_in(key, 99)))
    return (cfg, jm, params, hw, _rows("helmholtz-2d", batch, 5),
            _boundary("helmholtz-2d", batch, 6))


@pytest.mark.parametrize("mode,noise", [("tt", False), ("tonn", True)])
def test_composite_loss_is_residual_plus_weighted_boundary_mse(mode, noise):
    """residual_loss with the boundary batch equals L_r + bc_weight·MSE(u(xb),
    0) of the port's own parts (rtol 1e-5), and JAX's residual_loss with
    ``term_batches`` on the same params and rows (``HELM_LOSS_RTOL``);
    ``per_term_losses`` gives both parts unweighted, the boundary MSE equal
    to JAX's to rtol 1e-5."""
    cfg, jm, params, hw, xt, bc = _helm_setup(mode, noise)
    jtb = {"boundary": tuple(map(jnp.asarray, bc))}
    want = float(jax.jit(lambda p, h, x: jpinn.residual_loss(
        jm, p, x, h, term_batches=jtb))(params, hw, jnp.asarray(xt)))
    want_b = float(jnp.mean((jm.u(params, jtb["boundary"][0], hw)) ** 2))
    tm = _port_model(cfg)
    tp = interop.params_from_numpy(params, "cpu")
    noise_t = interop.noise_from_numpy(hw, "cpu")
    ttb = {"boundary": tuple(map(torch.tensor, bc))}
    x = torch.tensor(xt)
    got = float(tpinn.residual_loss(tm, tp, x, noise_t, term_batches=ttb))
    l_r = float(tpinn.residual_loss(tm, tp, x, noise_t))
    l_b = float(torch.mean(tm.u(tp, ttb["boundary"][0], noise_t) ** 2))
    assert tm.problem.bc_weight == 1.0
    assert got == pytest.approx(l_r + tm.problem.bc_weight * l_b, rel=1e-5)
    assert got == pytest.approx(want, rel=HELM_LOSS_RTOL)
    assert l_b == pytest.approx(want_b, rel=1e-5)
    per = tpinn.per_term_losses(tm, tp, x, noise_t, term_batches=ttb)
    assert set(per) == {"residual", "boundary"}
    assert float(per["residual"]) == pytest.approx(l_r, rel=1e-6)
    assert float(per["boundary"]) == pytest.approx(l_b, rel=1e-6)


def test_set_term_weights_overrides_and_rejects_unknown_names():
    """The counterpart of ``test_set_term_weights_override_and_validation``:
    overrides rescale each term of the composite loss, unknown names raise
    with JAX's message, and a fresh instance keeps the defaults."""
    cfg, jm, params, hw, xt, bc = _helm_setup()
    tm = _port_model(cfg)
    tp = interop.params_from_numpy(params, "cpu")
    x, ttb = torch.tensor(xt), {"boundary": tuple(map(torch.tensor, bc))}
    per = tpinn.per_term_losses(tm, tp, x, term_batches=ttb)
    prob = tm.problem
    prob.set_term_weights({"boundary": 3.0, "residual": 0.5})
    assert prob.term_weights() == {"residual": 0.5, "boundary": 3.0}
    got = float(tpinn.residual_loss(tm, tp, x, term_batches=ttb))
    assert got == pytest.approx(0.5 * float(per["residual"])
                                + 3.0 * float(per["boundary"]), rel=1e-5)
    jp = jpde.get_problem("helmholtz-2d")
    with pytest.raises(ValueError) as jerr:
        jp.set_term_weights({"not-a-term": 1.0})
    with pytest.raises(ValueError) as terr:
        prob.set_term_weights({"not-a-term": 1.0})
    assert str(terr.value) == str(jerr.value)
    assert tpde.get_problem("helmholtz-2d").term_weights() == {
        "residual": 1.0, "boundary": 1.0}


def test_cli_trains_helmholtz_with_per_term_losses(capsys):
    res = train.main(["--arch", "tensor-pinn", "--pde", "helmholtz-2d",
                      "--reduced", "--hidden", "16", "--pinn-noise",
                      "--device", "cpu", "--steps", "3", "--batch", "8",
                      "--zo-samples", "3", "--log-every", "1",
                      "--bc-weight", "2"])
    out = capsys.readouterr().out
    assert "[pinn] term weights: residual=1 boundary=2" in out
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(steps) == 3
    assert all("[residual=" in ln and " boundary=" in ln for ln in steps)
    assert res.model.problem.term_weights() == {"residual": 1.0,
                                                "boundary": 2.0}
    assert np.isfinite(res.losses).all() and np.isfinite(res.val_mse)


class _Args:
    def __init__(self, term_weight=None, bc_weight=None):
        self.term_weight, self.bc_weight = term_weight, bc_weight


@pytest.mark.parametrize("pde,term_weight,bc_weight", [
    ("helmholtz-2d", ["boundary"], None),            # malformed entry
    ("helmholtz-2d", ["boundary=2=3"], None),        # malformed entry
    ("helmholtz-2d", [" , "], None),                 # no weights given
    ("hjb-20d", None, 2.0),                          # no boundary term
    ("helmholtz-2d", ["wall=2"], None),              # unknown name
])
def test_term_weight_errors_exit_with_jaxs_message(pde, term_weight,
                                                   bc_weight):
    """Each refusal of ``--term-weight`` / ``--bc-weight`` exits with the
    JAX trainer's message, word for word, and through the CLI too."""
    from repro.launch import train as jtrain
    args = _Args(term_weight, bc_weight)
    with pytest.raises(SystemExit) as jerr:
        jtrain._apply_term_weights(args, jpde.get_problem(pde))
    with pytest.raises(SystemExit) as terr:
        train._apply_term_weights(args, tpde.get_problem(pde))
    assert str(terr.value) == str(jerr.value)
    argv = ["--arch", "tensor-pinn", "--pde", pde, "--reduced", "--device",
            "cpu", "--steps", "1"]
    argv += [f"--term-weight={w}" for w in term_weight or ()]
    argv += ["--bc-weight", str(bc_weight)] if bc_weight is not None else []
    with pytest.raises(SystemExit) as cli:
        train.main(argv)
    assert str(cli.value) == str(jerr.value)


def test_explicit_term_weight_wins_over_bc_weight():
    from repro.launch import train as jtrain
    args = _Args(["boundary=3,residual=0.5"], 2.0)
    jp, tp = jpde.get_problem("helmholtz-2d"), tpde.get_problem("helmholtz-2d")
    assert train._apply_term_weights(args, tp) == \
        jtrain._apply_term_weights(args, jp) == {"boundary": 3.0,
                                                 "residual": 0.5}
    assert tp.term_weights() == jp.term_weights() == {"residual": 0.5,
                                                      "boundary": 3.0}


@pytest.mark.parametrize("flags", [["--term-weight", "boundary=2.5"],
                                   ["--bc-weight", "2.5"]])
def test_term_weights_roundtrip_through_checkpoint_meta(tmp_path, flags):
    """The counterpart of ``tests/test_pde.py::test_term_weights_roundtrip_
    through_checkpoint_meta`` (which trains ns-2d): the weights set at
    train time go into the checkpoint's meta, and the serving registry
    restores them onto the loaded solver's problem."""
    from repro_torch.checkpoint import read_checkpoint_meta
    from repro_torch.serving import SolverRegistry
    train.main(["--arch", "tensor-pinn", "--pde", "helmholtz-2d", "--reduced",
                "--steps", "2", "--batch", "8", "--hidden", "16",
                "--pinn-mode", "tt", "--zo-samples", "3", "--log-every",
                "100", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                *flags])
    want = {"residual": 1.0, "boundary": 2.5}
    assert read_checkpoint_meta(tmp_path)["term_weights"] == want
    solver = SolverRegistry(device="cpu").load_checkpoint(
        "helm", tmp_path, device="cpu")
    assert solver.model.problem.term_weights() == want
    # names the problem does not know are dropped, as the JAX registry
    # drops them
    meta_path = next(tmp_path.glob("step_*/meta.json"))
    meta = json.loads(meta_path.read_text())
    meta["term_weights"]["ic"] = 9.0
    meta_path.write_text(json.dumps(meta))
    solver = SolverRegistry(device="cpu").load_checkpoint(
        "helm", tmp_path, device="cpu")
    assert solver.model.problem.term_weights() == want
    # a fresh problem of the registry keeps the defaults
    assert tpde.get_problem("helmholtz-2d").term_weights() == {
        "residual": 1.0, "boundary": 1.0}
