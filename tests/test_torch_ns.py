"""The port's 2-D Navier–Stokes workload (``repro_torch.pde.navier_stokes``)
against the JAX package: the counterpart of ``tests/test_ns.py`` at small
widths.

Covers the Taylor–Green identities, periodicity and decay, the FD and
spectral exact-solution residual floors, the ``Domain`` Jacobian, the
feature map making the network periodic, ``fd_fast`` running as ``fd``,
the ``ic`` and ``data`` batches, the three terms, the composite loss as the
weighted sum of its terms, stacked against sequential, both against JAX on
the same arrays, and a few steps of the CLI on the CPU with its checkpoint
served.  The reference's ``test_zo_training_improves_three_term_loss`` has
no counterpart: its bar fails in JAX itself (ROADMAP queue C).

Tolerances: the problem's elementwise functions ``rtol 1e-6`` with ``atol
1e-6·max|·|`` (cos, sin and exp of two libraries); u over rows
``max|Δ| ≤ U_RTOL·max|u|`` and losses within ``_loss_rtol`` (see
``tests/test_torch_spectral.py``).
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
from repro_torch import interop
from repro_torch import pde as tpde
from repro_torch.core import pinn as tpinn
from repro_torch.core import stein as tstein
from repro_torch.core import zoo as tzoo
from repro_torch.data import pde_term_batch_iterator
from repro_torch.launch import train
from repro_torch.pde.navier_stokes import TWO_PI
from test_torch_pinn import _np_tree, _port_model, share_cores  # noqa: F401
from test_torch_spectral import U_RTOL, _loss_rtol


def _ns_cfg(deriv="auto", hidden=16, mode="tt", tt_L=2):
    return jpinn.PINNConfig(hidden=hidden, mode=mode, tt_rank=2, tt_L=tt_L,
                            deriv=deriv, pde="ns-2d")


def _jax_rows(n, seed=0):
    return np.asarray(jpde.get_problem("ns-2d").sample_collocation(
        jax.random.PRNGKey(seed), n))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def _jax_terms(n, seed):
    """JAX's ic and data batches as numpy (the same arrays for both)."""
    jp = jpde.get_problem("ns-2d")
    return {"ic": tuple(map(np.asarray, jp.initial_batch(
                jax.random.PRNGKey(seed), n))),
            "data": tuple(map(np.asarray, jp.data_batch(
                jax.random.PRNGKey(seed + 1), n)))}


def _torch_terms(tb):
    return {k: tuple(torch.tensor(a) for a in v) for k, v in tb.items()}


# ---------------------------------------------------- Taylor–Green closed form

def test_problem_matches_jax():
    """The registry surface and every closed-form function on JAX's rows:
    the domain, the exact solution, the velocity, the feature map and the
    residual of a given estimate."""
    jp, tp = jpde.get_problem("ns-2d"), tpde.get_problem("ns-2d")
    for attr in ("name", "space_dim", "time_dependent", "in_dim", "net_dim",
                 "has_boundary_loss", "has_data_loss", "bc_weight",
                 "data_weight", "fd_step", "residual_tol", "estimator",
                 "spectral_points", "spectral_extent",
                 "spectral_periodization", "has_feature_map", "feature_dim",
                 "has_exact_solution", "nu", "margin", "data_noise"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    assert (tp.domain.lo, tp.domain.hi) == (jp.domain.lo, jp.domain.hi)
    np.testing.assert_array_equal(tp.domain.scales, jp.domain.scales)
    assert tp.term_weights() == jp.term_weights() == {
        "residual": 1.0, "ic": 1.0, "data": 1.0}
    z = _jax_rows(64)
    tz, jz = torch.tensor(z), jnp.asarray(z)
    _close(tp.domain.from_unit(tz), jp.domain.from_unit(jz))
    _close(tp.exact_solution(tz), jp.exact_solution(jz))
    for a, b in zip(tp._velocity_star(tp.domain.from_unit(tz)),
                    jp._velocity_star(jp.domain.from_unit(jz))):
        _close(a, b)
    _close(tp.embed_features(tz), jp.embed_features(jz))
    rs = np.random.RandomState(0)
    leaves = [rs.standard_normal(s).astype(np.float32)
              for s in ((64,), (64, 3), (64, 3))]
    want = jp.residual(jstein.DerivativeEstimate(*map(jnp.asarray, leaves)),
                       jz)
    got = tp.residual(tstein.DerivativeEstimate(*map(torch.tensor, leaves)),
                      tz)
    _close(got, want)


def test_taylor_green_identities():
    """ω* = ∂x v* − ∂y u*, the field is divergence-free and u*·∇ω*
    vanishes pointwise."""
    prob = tpde.get_problem("ns-2d")
    raw = prob.domain.from_unit(prob.sample_collocation(
        torch.Generator().manual_seed(0), 64)).double()
    eps = 1e-4
    ex = torch.tensor([eps, 0.0, 0.0], dtype=torch.float64)
    ey = torch.tensor([0.0, eps, 0.0], dtype=torch.float64)

    def u_of(r):
        return prob._velocity_star(r)[0]

    def v_of(r):
        return prob._velocity_star(r)[1]

    curl = ((v_of(raw + ex) - v_of(raw - ex))
            - (u_of(raw + ey) - u_of(raw - ey))) / (2 * eps)
    np.testing.assert_allclose(curl.numpy(), prob._omega_star(raw).numpy(),
                               rtol=1e-6, atol=1e-7)
    div = ((u_of(raw + ex) - u_of(raw - ex))
           + (v_of(raw + ey) - v_of(raw - ey))) / (2 * eps)
    np.testing.assert_allclose(div.numpy(), 0.0, atol=1e-7)
    u, v = prob._velocity_star(raw)
    e = prob._decay(raw[..., 2])
    w_x = -2.0 * torch.sin(raw[..., 0]) * torch.cos(raw[..., 1]) * e
    w_y = -2.0 * torch.cos(raw[..., 0]) * torch.sin(raw[..., 1]) * e
    np.testing.assert_allclose((u * w_x + v * w_y).numpy(), 0.0, atol=1e-12)


def test_exact_solution_periodic_and_decaying():
    prob = tpde.get_problem("ns-2d")
    z = prob.sample_collocation(torch.Generator().manual_seed(1), 32)
    w = prob.exact_solution(z)
    for shift in ([1.0, 0.0, 0.0], [0.0, 1.0, 0.0]):
        np.testing.assert_allclose(
            prob.exact_solution(z + torch.tensor(shift)).numpy(), w.numpy(),
            atol=1e-5)
    z1 = z.clone()
    z1[:, 2] += 0.1
    np.testing.assert_allclose(prob.exact_solution(z1).numpy(),
                               (w * np.exp(-2.0 * prob.nu * 0.1)).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float(z[:, 2].min()) >= prob.margin
    assert float(z[:, 2].max()) <= 1 - prob.margin


# ------------------------------------------------- residual floors & geometry

def test_fd_residual_floor_documented():
    """f32 FD at fd_step on the unit box, Jacobian-scaled: the exact
    solution's residual MSE sits under ``residual_tol``, as JAX's does."""
    tp, jp = tpde.get_problem("ns-2d"), jpde.get_problem("ns-2d")
    xt = _jax_rows(256)
    est = tstein.fd_estimate(tp.exact_solution, torch.tensor(xt),
                             h=tp.fd_step, n_active=3)
    r = tp.residual(tp.scale_estimate(est), torch.tensor(xt))
    mse = float(torch.mean(r * r))
    jest = jstein.fd_estimate(jp.exact_solution, jnp.asarray(xt),
                              h=jp.fd_step, n_active=3)
    jr = jp.residual(jp.scale_estimate(jest), jnp.asarray(xt))
    assert mse < tp.residual_tol, mse
    assert float(jnp.mean(jr * jr)) < tp.residual_tol


def test_spectral_residual_floor_is_tighter_than_fd():
    """The declared estimator (periodic x, y; windowed t) on ω*: its floor
    beats FD's by orders (the reference's 1e-9)."""
    prob = tpde.get_problem("ns-2d")
    xt = torch.tensor(_jax_rows(256))
    est = tpde.estimate_for_problem(prob, prob.exact_solution, xt)
    r = prob.residual(est, xt)
    mse = float(torch.mean(r * r))
    assert mse < 1e-9, mse


def test_domain_jacobian_scaling():
    """``scale_estimate`` divides grad by (2π, 2π, 1) and hess_diag by the
    squares, against analytic raw derivatives of ω*; the identity (the same
    object) for a problem without a domain."""
    prob = tpde.get_problem("ns-2d")
    z = torch.tensor(_jax_rows(64, seed=3))
    raw = prob.domain.from_unit(z)
    np.testing.assert_allclose(raw[:, 0].numpy(), (z[:, 0] * TWO_PI).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(prob.domain.to_unit(raw).numpy(), z.numpy(),
                               atol=1e-6)
    est = tstein.fd_estimate(prob.exact_solution, z, h=prob.fd_step)
    scaled = prob.scale_estimate(est)
    w = prob._omega_star(raw)
    e = prob._decay(raw[:, 2])
    w_x = -2.0 * torch.sin(raw[:, 0]) * torch.cos(raw[:, 1]) * e
    np.testing.assert_allclose(scaled.grad[:, 0].numpy(), w_x.numpy(),
                               atol=5e-3)
    np.testing.assert_allclose(scaled.grad[:, 2].numpy(),
                               (-2.0 * prob.nu * w).numpy(), atol=1e-3)
    np.testing.assert_allclose(scaled.hess_diag[:, 0].numpy(),
                               (-w).numpy(), atol=1e-2)
    heat = tpde.get_problem("heat-10d")
    est_h = tstein.fd_estimate(heat.exact_solution, torch.rand(4, 11),
                               h=heat.fd_step)
    assert heat.scale_estimate(est_h) is est_h
    unit = type("Unit", (tpde.PDEProblem,), {
        "domain": tpde.Domain((0.0, 0.0), (1.0, 1.0))})()
    assert unit.domain.is_unit and unit.scale_estimate(est_h) is est_h


# ----------------------------------------------------- feature map / network

def test_feature_map_makes_network_exactly_periodic():
    """The port's network on ns-2d is 1-periodic in z_x and z_y, and its u
    equals JAX's on the same params and rows."""
    cfg = _ns_cfg()
    jm, tm = jpinn.TensorPinn(cfg), _port_model(cfg)
    assert tm.problem.has_feature_map and tm.feat_in == 5
    assert tm.in_pad == jm.in_pad and tm.dims == jm.dims
    params = jm.init(jax.random.PRNGKey(0))
    tp = interop.params_from_numpy(_np_tree(params), "cpu")
    z = _jax_rows(32, seed=1)
    u0 = tm.u(tp, torch.tensor(z))
    ju = np.asarray(jm.u(params, jnp.asarray(z)))
    assert float((u0 - torch.tensor(ju)).abs().max()) <= U_RTOL * float(
        np.abs(ju).max())
    for shift in ([1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [2.0, -1.0, 0.0]):
        np.testing.assert_allclose(
            tm.u(tp, torch.tensor(z) + torch.tensor(shift)).detach().numpy(),
            u0.detach().numpy(), atol=1e-5)


def test_fd_fast_downgrades_to_fd_bit_identically():
    """The Fourier feature map is not affine, so ``fd_fast`` resolves to
    plain ``fd``: the same loss, bit for bit, one model and stacked."""
    m_fast = _port_model(_ns_cfg("fd_fast"))
    m_fd = _port_model(_ns_cfg("fd"))
    params = m_fd.init(torch.Generator().manual_seed(0))
    xt = torch.tensor(_jax_rows(8, seed=1))
    assert torch.equal(tpinn.residual_loss(m_fast, params, xt),
                       tpinn.residual_loss(m_fd, params, xt))
    stacked = tzoo.tree_map(lambda t: torch.stack([t, 1.01 * t]), params)
    assert torch.equal(tpinn.residual_losses_stacked(m_fast, stacked, xt),
                       tpinn.residual_losses_stacked(m_fd, stacked, xt))


# -------------------------------------------------------- term batch contracts

def test_initial_batch_is_t0_slice_with_exact_target():
    prob = tpde.get_problem("ns-2d")
    zb, w0 = prob.initial_batch(torch.Generator().manual_seed(0), 64)
    assert tuple(zb.shape) == (64, 3) and tuple(w0.shape) == (64,)
    assert zb.dtype == w0.dtype == torch.float32
    np.testing.assert_array_equal(zb[:, 2].numpy(), 0.0)
    np.testing.assert_allclose(
        w0.numpy(), (2.0 * torch.cos(TWO_PI * zb[:, 0])
                     * torch.cos(TWO_PI * zb[:, 1])).numpy(), rtol=1e-5)
    zb2, w2 = prob.boundary_batch(torch.Generator().manual_seed(0), 64)
    assert torch.equal(zb2, zb) and torch.equal(w2, w0)


def test_data_batch_deterministic_noisy_observations():
    prob = tpde.get_problem("ns-2d")
    zd, obs = prob.data_batch(torch.Generator().manual_seed(7), 512)
    zd2, obs2 = prob.data_batch(torch.Generator().manual_seed(7), 512)
    assert torch.equal(zd, zd2) and torch.equal(obs, obs2)
    _, obs3 = prob.data_batch(torch.Generator().manual_seed(8), 512)
    assert not torch.equal(obs, obs3)
    resid = (obs - prob.exact_solution(zd)).numpy()
    assert 0.5 * prob.data_noise < resid.std() < 2.0 * prob.data_noise


def test_term_batch_stream_is_counter_keyed():
    """``pde_term_batch_iterator`` on ns-2d: both terms a step, ``n`` rows
    each, and a stream started at step k replays step k bit for bit."""
    it = pde_term_batch_iterator(8, seed=4, pde="ns-2d")
    first, second = next(it), next(it)
    assert set(first) == {"ic", "data"}
    for x, y in first.values():
        assert tuple(x.shape) == (8, 3) and tuple(y.shape) == (8,)
    resumed = next(pde_term_batch_iterator(8, seed=4, start_step=1,
                                           pde="ns-2d"))
    for name in second:
        for a, b in zip(resumed[name], second[name]):
            assert torch.equal(a, b)
    assert not torch.equal(first["data"][1], second["data"][1])


def test_loss_terms_exposes_all_three_kinds():
    prob = tpde.get_problem("ns-2d")
    assert [(t.name, t.kind) for t in prob.loss_terms()] == [
        ("residual", "collocation"), ("ic", "boundary"), ("data", "data")]
    assert all(t.sample is not None for t in prob.loss_terms())


# -------------------------------------------------------- composite loss path

def test_composite_loss_decomposes_as_weighted_term_sum():
    """``residual_loss`` is Σ w_k·``per_term_losses``[k] with all three
    batches (weights 1, 2, 0.5), and each term equals JAX's on the same
    params and batches."""
    cfg = _ns_cfg()
    jm, tm = jpinn.TensorPinn(cfg), _port_model(cfg)
    weights = {"ic": 2.0, "data": 0.5}
    jm.problem.set_term_weights(weights)
    tm.problem.set_term_weights(weights)
    params = jm.init(jax.random.PRNGKey(0))
    tp = interop.params_from_numpy(_np_tree(params), "cpu")
    xt = _jax_rows(16, seed=1)
    tb = _jax_terms(16, seed=2)
    with torch.no_grad():
        total = float(tpinn.residual_loss(tm, tp, torch.tensor(xt),
                                          term_batches=_torch_terms(tb)))
        parts = tpinn.per_term_losses(tm, tp, torch.tensor(xt),
                                      term_batches=_torch_terms(tb))
    assert set(parts) == {"residual", "ic", "data"}
    w = tm.problem.term_weights()
    assert total == pytest.approx(
        sum(w[k] * float(v) for k, v in parts.items()), rel=1e-5)
    jtb = {k: tuple(map(jnp.asarray, v)) for k, v in tb.items()}
    jparts = jax.jit(lambda p: jpinn.per_term_losses(
        jm, p, jnp.asarray(xt), term_batches=jtb))(params)
    for k in ("ic", "data"):
        assert float(parts[k]) == pytest.approx(float(jparts[k]), rel=1e-5)
    assert float(parts["residual"]) == pytest.approx(
        float(jparts["residual"]), rel=_loss_rtol(3, 16))


def test_spectral_stacked_matches_sequential_with_terms():
    """The declared-estimator ZO hot path with all three terms: stacked
    losses against a loop of one-model losses in the port, and against
    JAX's stacked losses on the same stack and batches."""
    cfg = _ns_cfg()
    jm, tm = jpinn.TensorPinn(cfg), _port_model(cfg)
    plist = [jm.init(k) for k in jax.random.split(jax.random.PRNGKey(0), 3)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *plist)
    xt = _jax_rows(8, seed=1)
    tb = _jax_terms(8, seed=2)
    jtb = {k: tuple(map(jnp.asarray, v)) for k, v in tb.items()}
    want = np.asarray(jax.jit(lambda sp: jpinn.residual_losses_stacked(
        jm, sp, jnp.asarray(xt), term_batches=jtb))(stacked))
    with torch.no_grad():
        sp = interop.params_from_numpy(_np_tree(stacked), "cpu")
        got = tpinn.residual_losses_stacked(tm, sp, torch.tensor(xt),
                                            term_batches=_torch_terms(tb))
        seq = [tpinn.residual_loss(
            tm, interop.params_from_numpy(_np_tree(p), "cpu"),
            torch.tensor(xt), term_batches=_torch_terms(tb)) for p in plist]
    rtol = _loss_rtol(3, 16)
    np.testing.assert_allclose(got.numpy(), [float(s) for s in seq],
                               rtol=rtol)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)


# --------------------------------------------------------------- the CLI

def test_cli_trains_ns2d_by_its_estimator_and_serves(tmp_path, capsys):
    """A few steps of the port's trainer on ns-2d, ``--estimator auto``
    (spectral), tonn with noise at hidden 16: finite losses, the three
    terms logged, the checkpoint's meta with the estimator and weights,
    and the checkpoint served through ``SolverRegistry`` and the engine
    equal to the trainer's own ``model.u``."""
    from repro_torch.checkpoint import read_checkpoint_meta
    from repro_torch.serving import (PdeServingEngine, PointRequest,
                                     SolverRegistry)
    res = train.main(["--arch", "tensor-pinn", "--pde", "ns-2d", "--reduced",
                      "--hidden", "16", "--pinn-noise", "--estimator",
                      "auto", "--steps", "3", "--batch", "8",
                      "--zo-samples", "3", "--log-every", "1", "--device",
                      "cpu", "--ckpt-dir", str(tmp_path), "--bc-weight",
                      "2"])
    out = capsys.readouterr().out
    assert "deriv=auto" in out and "ic=" in out and "data=" in out
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert np.isfinite(res.val_mse)
    assert tpinn._resolve_deriv(res.model.cfg, res.model.problem) == \
        "spectral"
    meta = read_checkpoint_meta(tmp_path)
    assert meta["pinn"]["deriv"] == "auto" and meta["pde"] == "ns-2d"
    assert meta["term_weights"] == {"residual": 1.0, "ic": 2.0, "data": 1.0}
    reg = SolverRegistry(device="cpu")
    solver = reg.load_checkpoint("ns", tmp_path, device="cpu")
    assert solver.problem.term_weights() == meta["term_weights"]
    engine = PdeServingEngine(reg, slots=2, slot_points=16, device="cpu")
    pts = solver.problem.sample_collocation(torch.Generator().manual_seed(5),
                                            40)
    req = engine.submit(PointRequest("ns", pts.numpy()))
    engine.run()
    with torch.no_grad():
        direct = res.model.u(res.params, pts, res.hw_noise).numpy()
    np.testing.assert_allclose(req.out, direct, rtol=1e-6, atol=1e-6)


def test_cli_trains_hjb_by_spectral_with_spectral_points(tmp_path):
    """``--estimator spectral --spectral-points 8`` on hjb-20d: the grid
    size goes into the config and the checkpoint, and the run trains."""
    from repro_torch.checkpoint import read_checkpoint_meta
    res = train.main(["--arch", "tensor-pinn", "--pde", "hjb-20d",
                      "--reduced", "--hidden", "16", "--estimator",
                      "spectral", "--spectral-points", "8", "--steps", "2",
                      "--batch", "4", "--zo-samples", "2", "--log-every",
                      "10", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert res.model.cfg.spectral_points == 8
    assert np.isfinite(res.losses).all() and np.isfinite(res.val_mse)
    meta = read_checkpoint_meta(tmp_path)["pinn"]
    assert (meta["deriv"], meta["spectral_points"]) == ("spectral", 8)
    assert json.loads(json.dumps(meta)) == meta
