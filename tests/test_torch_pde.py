"""The port's PDE problems (heat, Black–Scholes, HJB), its Stein estimator,
``estimate_for_problem`` and the Stein paths of the loss engine, against the
JAX package: the counterpart of ``tests/test_pde.py`` for these problems.

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
* stacked stencil u: ``max|Δ| ≤ 1e-6·max|u|``; FD losses ``rtol 1e-1``
  over ``LOSS_BATCH`` points (the FD floor, DESIGN.md §Perf).
"""

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
from test_torch_pinn import _np_tree, _port_model

PDES = ("hjb-10d", "hjb-20d", "heat-10d", "heat-20d", "black-scholes-100d")
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
    assert tp.in_dim == tp.space_dim + 1 == jp.in_dim
    for attr in ("space_dim", "time_dependent", "has_boundary_loss",
                 "fd_step", "residual_tol", "estimator", "margin",
                 "has_exact_solution"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    if name.startswith("black-scholes"):
        assert (tp.sigma, tp.r) == (jp.sigma, jp.r) == (0.4, 0.05)
    assert tp.term_weights() == jp.term_weights() == {"residual": 1.0}


def test_heat_floor_is_the_references():
    assert tpde.get_problem("heat-20d").residual_tol == 1e-2
    assert tpde.HeatProblem(space_dim=3).residual_tol == 1e-2


@pytest.mark.parametrize("name", PDES)
def test_collocation_shapes_and_bounds(name):
    tp = tpde.get_problem(name)
    pts = tp.sample_collocation(torch.Generator().manual_seed(3), 257)
    assert tuple(pts.shape) == (257, tp.in_dim) and pts.dtype == torch.float32
    m = tp.margin
    x, t = pts[:, :-1], pts[:, -1]
    lo = 0.5 + m if name.startswith("black-scholes") else m
    assert float(x.min()) >= lo and float(x.max()) <= lo + 1 - 2 * m
    assert float(t.min()) >= m and float(t.max()) <= 1 - m
    # and JAX's rows lie in the same box
    jx = _rows(name, 257)
    assert jx.min(0)[:-1].min() >= lo and jx.max(0)[:-1].max() <= lo + 1 - 2 * m


@pytest.mark.parametrize("name", PDES)
def test_ansatz_residual_and_exact_solution_match_jax(name):
    """On JAX's collocation rows: ``ansatz`` of a given f, ``residual`` of
    a given estimate and ``exact_solution``."""
    jp, tp = jpde.get_problem(name), tpde.get_problem(name)
    xt = _rows(name)
    B, A = xt.shape
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
        x, t = r[..., :D], r[..., D]
        if jp.name.startswith("heat"):
            tau = jp.s + 1.0 - t
            q = np.sum((x - jp.center) ** 2, axis=-1)
            u = (jp.s / tau) ** (D / 2.0) * np.exp(-q / (4.0 * tau))
        elif jp.name.startswith("black-scholes"):
            u = np.exp((jp.r + jp.sigma ** 2) * (1.0 - t)) \
                * np.sum(x * x, axis=-1) / D
        else:
            u = np.sum(np.abs(x), axis=-1) + 1.0 - t
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
    with pytest.raises(NotImplementedError, match="item 9a"):
        tpde.estimate_for_problem(tp, tp.exact_solution, xt,
                                  estimator="spectral")
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
    whatever f is."""
    for name in PDES:
        tp = tpde.get_problem(name)
        xt = tp.sample_collocation(torch.Generator().manual_seed(0), 9)
        xt[:, -1] = 1.0
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
            "bs100-tonn-noise": ("black-scholes-100d", "tonn", True)}


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


@pytest.mark.parametrize("label", sorted(FD_CASES))
def test_stacked_fd_stencil_and_losses_match_jax(label):
    """From JAX's params: the stacked stencil u against JAX's within
    1e-6·max|u|, and the (P,) losses at the FD floor (rtol 1e-1 over
    ``LOSS_BATCH`` points).  The ±1 diag buffers stay unperturbed."""
    cfg, jm, stacked, hw, xt = _fd_setup(label, LOSS_BATCH)

    @jax.jit
    def reference(s, h, x):
        prep = jm.prepare_params_stacked(s, h)
        return (jm.fd_u_stencil_stacked(prep, x, jm.fd_step),
                jpinn.residual_losses_stacked(jm, s, x, h))

    want_u, want_l = (np.asarray(a) for a in reference(
        stacked, hw, jnp.asarray(xt)))
    tm = _port_model(cfg)
    noise = interop.noise_from_numpy(hw, "cpu")
    tstacked = interop.params_from_numpy(stacked, "cpu")
    tprep = tm.prepare_params_stacked(tstacked, noise)
    got_u = tm.fd_u_stencil_stacked(tprep, torch.tensor(xt), tm.fd_step)
    assert tuple(got_u.shape) == (3, 2 * tm.in_dim + 1, LOSS_BATCH)
    assert _relmax(got_u.numpy(), want_u) <= 1e-6
    got_l = tpinn.residual_losses_stacked(tm, tstacked, torch.tensor(xt),
                                          noise)
    assert torch.isfinite(got_l).all()
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=1e-1)


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
