"""The port's zeroth-order optimizer against the JAX package's.

Given the ξ stack and the loss vector the JAX side made (handed over as
numpy), the reconstructed SPSA gradient and the sign-SGD update must match,
and the photonic ±1 buffers must stay bit-frozen.  The sequential path
(``spsa_losses``, ``loss_fn`` without ``batched_loss_fn``) evaluates the
same perturbed models one at a time: on a u-level loss (a fixed weighting
of u over ``LOSS_BATCH`` points) its losses match JAX's ``rtol=1e-5`` (an
antithetic difference ``1e-5`` of the base loss) and
its gradient within ``1e-3·max|ĝ|`` (ĝ divides loss differences of ~μ by
μ, so the losses' 1e-6 grows to ~1e-4 of ĝ); on the FD residual loss its
losses match at the FD noise floor, ``rtol=2.5e-1`` (two f32 paths, u
within 1e-6, second differences amplified by 1/h² = 1e4: 2-15% measured
at 96 points).  JAX's threefry and
torch's Philox give different draws, so nothing here compares draws from a
seed across packages.  Tolerance: gradients ``rtol=1e-5, atol=1e-6`` (one
tensordot of N terms per leaf, summed in another order); updated params
``atol=1e-7`` beyond the update itself — the sign agrees wherever
``|ĝ|`` is not within rounding of 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pinn as jpinn
from repro.core import zoo as jzoo
from repro.core.photonic import NoiseModel as JNoise
from repro_torch import interop
from repro_torch.core import pinn as tpinn
from repro_torch.core import zoo as tzoo
from repro_torch.device import counter_generator
from test_torch_pinn import share_cores  # noqa: F401 (autouse)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _solver(mode, hidden=16, tt_L=3):
    cfg = jpinn.PINNConfig(hidden=hidden, mode=mode, tt_L=tt_L,
                           pde="hjb-20d", noise=JNoise(enabled=True))
    jm = jpinn.TensorPinn(cfg)
    params = jm.init(jax.random.PRNGKey(3))
    tm = tpinn.TensorPinn(tpinn.config_from_meta(jpinn.config_to_meta(cfg)))
    return jm, tm, params


def test_tree_order_is_the_jax_flattening_order():
    jm, tm, params = _solver("tonn")
    tparams = interop.params_from_numpy(_np(params), "cpu")
    got = [t.numpy() for t in tzoo.tree_leaves(tparams)]
    want = jax.tree.leaves(_np(params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    doubled = tzoo.tree_map(lambda a, b: a + b, tparams, tparams)
    assert jax.tree.structure(doubled) == jax.tree.structure(params)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("mode", ["tt", "tonn"])
def test_gradient_and_sign_update_match_jax(mode, antithetic):
    """JAX's ``zo_signsgd_step`` with a batched loss that returns a fixed
    (P,) vector, against the port's reconstruction from the same ξ stack
    and losses, then the port's update."""
    jm, tm, params = _solver(mode)
    mask = jm.trainable_mask(params)
    cfg = jzoo.SPSAConfig(num_samples=4, mu=0.01, antithetic=antithetic)
    tcfg = tzoo.SPSAConfig(num_samples=4, mu=0.01, antithetic=antithetic)
    P = 1 + (2 if antithetic else 1) * cfg.num_samples
    all_l = np.random.RandomState(P).uniform(0.5, 1.5, P).astype(np.float32)
    state = jzoo.ZOState.create(7)
    new_j, _, base_j = jzoo.zo_signsgd_step(
        None, params, state, lr=2e-3, cfg=cfg,
        batched_loss_fn=lambda sp: jnp.asarray(all_l), trainable_mask=mask)
    # the ξ stack JAX drew inside the step, and the gradient it took
    xis = jzoo.sample_perturbations(jax.random.split(state.key)[1], params,
                                    cfg.num_samples, mask)
    n = cfg.num_samples
    losses = (0.5 * (all_l[1:n + 1] - all_l[n + 1:]) if antithetic
              else all_l[1:])
    grad_j = jzoo.spsa_gradient_from_losses(params, None, jnp.asarray(losses),
                                            jnp.asarray(all_l[0]), cfg,
                                            xis=xis)

    tparams = interop.params_from_numpy(_np(params), "cpu")
    grad = tzoo.spsa_gradient_from_losses(
        torch.tensor(losses), torch.tensor(all_l[0]), tcfg,
        interop.params_from_numpy(_np(xis), "cpu"))
    for g, w in zip(tzoo.tree_leaves(grad), jax.tree.leaves(_np(grad_j))):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
        sure = np.abs(w) > 1e-4 * np.abs(w).max(initial=0.0)
        np.testing.assert_array_equal(np.sign(g.numpy())[sure],
                                      np.sign(w)[sure])
    new = tzoo.apply_update(tparams, grad, 2e-3)
    for got, want, old, train in zip(
            tzoo.tree_leaves(new), jax.tree.leaves(_np(new_j)),
            tzoo.tree_leaves(tparams), jax.tree.leaves(mask)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
        if not train:                       # ±1 diag buffers: bit-frozen
            assert torch.equal(got, old)
    assert float(base_j) == all_l[0]


def test_perturbed_stack_matches_jax_and_masks_buffers():
    jm, tm, params = _solver("tonn")
    mask = jm.trainable_mask(params)
    xis = jzoo.sample_perturbations(jax.random.PRNGKey(1), params, 3, mask)
    want = jax.tree.map(
        lambda p, z: p + 0.01 * jnp.concatenate([jnp.zeros_like(z[:1]), z]),
        params, xis)
    got = tzoo.perturbed_stack(interop.params_from_numpy(_np(params), "cpu"),
                               interop.params_from_numpy(_np(xis), "cpu"),
                               tzoo.SPSAConfig(num_samples=3))
    for g, w in zip(tzoo.tree_leaves(got), jax.tree.leaves(_np(want))):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
    # the port's own draws: zero on buffers, N(0, 1) elsewhere, and the
    # same draws again from the same counters
    tparams = interop.params_from_numpy(_np(params), "cpu")
    tmask = tm.trainable_mask(tparams)
    a = tzoo.sample_perturbations(counter_generator(5, 0), tparams, 64, tmask)
    b = tzoo.sample_perturbations(counter_generator(5, 0), tparams, 64, tmask)
    one = tzoo.sample_perturbation(counter_generator(5, 0), tparams, tmask)
    for x, y, z, train in zip(tzoo.tree_leaves(a), tzoo.tree_leaves(b),
                              tzoo.tree_leaves(one), tzoo.tree_leaves(tmask)):
        assert torch.equal(x, y) and z.shape == x.shape[1:]
        if not train:
            assert not x.any() and not z.any()
    flat = torch.cat([x.flatten() for x, t in
                      zip(tzoo.tree_leaves(a), tzoo.tree_leaves(tmask)) if t])
    assert abs(float(flat.mean())) < 0.05 and abs(float(flat.std()) - 1) < 0.05


def test_zo_signsgd_step_descends_and_freezes_buffers():
    """A full port step on a loss with a known minimum: the loss falls,
    buffers keep their bits, and the step is a function of (seed, step)."""
    jm, tm, params = _solver("tonn")
    tparams = interop.params_from_numpy(_np(params), "cpu")
    mask = tm.trainable_mask(tparams)
    target = tzoo.tree_map(lambda p: torch.full_like(p, 0.3), tparams)

    def losses(sp):
        terms = [((p - t) ** 2).flatten(1).sum(1) for p, t, m in zip(
            tzoo.tree_leaves(sp), tzoo.tree_leaves(target),
            tzoo.tree_leaves(mask)) if m]
        return torch.stack(terms).sum(0)

    cfg = tzoo.SPSAConfig(num_samples=10, mu=0.01)
    state = tzoo.ZOState(step=0, seed=1)
    p = tparams
    first = None
    for _ in range(30):
        p, state, base = tzoo.zo_signsgd_step(p, state, 1e-2, cfg, losses,
                                              trainable_mask=mask)
        first = float(base) if first is None else first
    assert float(losses(tzoo.tree_map(lambda x: x[None], p))[0]) < 0.9 * first
    assert state.step == 30
    for new, old, train in zip(tzoo.tree_leaves(p), tzoo.tree_leaves(tparams),
                               tzoo.tree_leaves(mask)):
        if not train:
            assert torch.equal(new, old)
    again, _, _ = tzoo.zo_signsgd_step(tparams, tzoo.ZOState(0, 1), 1e-2, cfg,
                                       losses, trainable_mask=mask)
    once, _, _ = tzoo.zo_signsgd_step(tparams, tzoo.ZOState(0, 1), 1e-2, cfg,
                                      losses, trainable_mask=mask)
    assert all(torch.equal(x, y) for x, y in zip(tzoo.tree_leaves(again),
                                                  tzoo.tree_leaves(once)))
    assert tzoo.ZOState.from_tree(state.as_tree()) == state
    # without a batched evaluator the sequential path needs a loss_fn
    with pytest.raises(ValueError, match="loss_fn"):
        tzoo.spsa_gradient(tparams, counter_generator(0), cfg, None)


LOSS_BATCH = 96


def _u_loss(model, pts, w, noise, package):
    """A u-level functional, mean(u · w): no FD stencil in it."""
    if package == "jax":
        return jax.jit(lambda p: jnp.mean(model.u(p, jnp.asarray(pts), noise)
                                          * w))
    return lambda p: torch.mean(model.u(p, torch.tensor(pts), noise)
                                * torch.tensor(w))


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("mode", ["tt", "tonn"])
def test_sequential_path_matches_jax(mode, antithetic):
    """``spsa_losses``, the sequential ``spsa_gradient`` and
    ``zo_signsgd_step(loss_fn=...)`` against JAX's on the same ξ."""
    jm, tm, params = _solver(mode)
    mask = jm.trainable_mask(params)
    hw = jm.sample_noise(jax.random.PRNGKey(9))
    nz = interop.noise_from_numpy(_np(hw), "cpu")
    rng = np.random.RandomState(11)
    pts = rng.uniform(0.02, 0.98, (LOSS_BATCH, jm.net_in)).astype(np.float32)
    w = rng.standard_normal(LOSS_BATCH).astype(np.float32)
    cfg = jzoo.SPSAConfig(num_samples=4, mu=0.01, antithetic=antithetic)
    tcfg = tzoo.SPSAConfig(num_samples=4, mu=0.01, antithetic=antithetic)
    key = jax.random.PRNGKey(21)
    xis = jzoo.sample_perturbations(key, params, cfg.num_samples, mask)
    txis = interop.params_from_numpy(_np(xis), "cpu")
    tparams = interop.params_from_numpy(_np(params), "cpu")
    tmask = tm.trainable_mask(tparams)
    jl, tl = _u_loss(jm, pts, w, hw, "jax"), _u_loss(tm, pts, w, nz, "torch")

    want = np.asarray(jzoo.spsa_losses(jl, params, key, cfg, xis=xis,
                                       trainable_mask=mask))
    with torch.no_grad():
        got = tzoo.spsa_losses(tl, tparams, None, tcfg, xis=txis)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4,)
    # antithetic entries are (L+ − L−)/2, differences of ~μ: held to the
    # losses' own scale
    scale = abs(float(jl(params)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale + 1e-7)

    # JAX's sequential gradient draws ξ_i from split keys: the stack above
    grad_j, base_j = jzoo.spsa_gradient(jl, params, key, cfg,
                                        trainable_mask=mask)
    with torch.no_grad():
        grad, base = tzoo.spsa_gradient(tparams, None, tcfg,
                                        trainable_mask=tmask, loss_fn=tl,
                                        xis=txis)
    np.testing.assert_allclose(float(base), float(base_j), rtol=1e-5)
    for g, wj in zip(tzoo.tree_leaves(grad), jax.tree.leaves(_np(grad_j))):
        scale = np.abs(wj).max(initial=0.0)
        np.testing.assert_allclose(g.numpy(), wj, rtol=0,
                                   atol=1e-3 * scale + 1e-9)

    # the whole step, ξ handed over in place of the port's own draw
    state = jzoo.ZOState.create(5)
    new_j, _, _ = jzoo.zo_signsgd_step(jl, params, state, lr=2e-3, cfg=cfg,
                                       trainable_mask=mask)
    step_xis = interop.params_from_numpy(_np(jzoo.sample_perturbations(
        jax.random.split(state.key)[1], params, cfg.num_samples, mask)),
        "cpu")
    grad_j, _ = jzoo.spsa_gradient(jl, params, jax.random.split(state.key)[1],
                                   cfg, trainable_mask=mask)
    orig = tzoo.sample_perturbations
    tzoo.sample_perturbations = lambda *a, **k: step_xis
    try:
        with torch.no_grad():
            new, st, _ = tzoo.zo_signsgd_step(tparams, tzoo.ZOState(0, 5),
                                              2e-3, tcfg, loss_fn=tl,
                                              trainable_mask=tmask)
    finally:
        tzoo.sample_perturbations = orig
    assert st.step == 1
    for got, want, g, old, train in zip(
            tzoo.tree_leaves(new), jax.tree.leaves(_np(new_j)),
            jax.tree.leaves(_np(grad_j)), tzoo.tree_leaves(tparams),
            tzoo.tree_leaves(tmask)):
        sure = np.abs(g) > 1e-2 * np.abs(g).max(initial=0.0)
        np.testing.assert_allclose(got.numpy()[sure], want[sure], rtol=0,
                                   atol=1e-7)
        if not train:
            assert torch.equal(got, old)


@pytest.mark.parametrize("mode", ["tt", "tonn"])
def test_sequential_residual_losses_match_jax_at_the_fd_floor(mode):
    """The trainer's ``--sequential`` loss (plain FD stencil, one model at
    a time) against JAX's on the same ξ: u strict above, losses here at
    the FD noise floor."""
    cfg = jpinn.PINNConfig(hidden=64, mode=mode, tt_L=3, pde="hjb-20d",
                           deriv="fd", noise=JNoise(enabled=mode == "tonn"))
    jm = jpinn.TensorPinn(cfg)
    params = jm.init(jax.random.PRNGKey(3))
    hw = jm.sample_noise(jax.random.PRNGKey(99))
    mask = jm.trainable_mask(params)
    tm = tpinn.TensorPinn(tpinn.config_from_meta(jpinn.config_to_meta(cfg)))
    xt = np.random.RandomState(13).uniform(
        0.02, 0.98, (LOSS_BATCH, jm.net_in)).astype(np.float32)
    scfg = jzoo.SPSAConfig(num_samples=3, mu=0.01)
    key = jax.random.PRNGKey(8)
    xis = jzoo.sample_perturbations(key, params, 3, mask)
    want = np.asarray(jzoo.spsa_losses(
        jax.jit(lambda p: jpinn.residual_loss(jm, p, jnp.asarray(xt), hw)),
        params,
        key, scfg, xis=xis, trainable_mask=mask))
    nz = interop.noise_from_numpy(_np(hw), "cpu")
    with torch.no_grad():
        got = tzoo.spsa_losses(
            lambda p: tpinn.residual_loss(tm, p, torch.tensor(xt), nz),
            interop.params_from_numpy(_np(params), "cpu"), None,
            tzoo.SPSAConfig(num_samples=3, mu=0.01),
            xis=interop.params_from_numpy(_np(xis), "cpu"))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-1)


def test_sequential_and_fused_paths_see_the_same_perturbations():
    """One seed, one step: the sequential path (N+1 ``loss_fn`` calls) and
    the fused one (one ``batched_loss_fn`` call over the stack) draw the
    same ξ from the step's generator and give the same step."""
    jm, tm, params = _solver("tonn")
    hw = jm.sample_noise(jax.random.PRNGKey(9))
    nz = interop.noise_from_numpy(_np(hw), "cpu")
    tparams = interop.params_from_numpy(_np(params), "cpu")
    mask = tm.trainable_mask(tparams)
    rng = np.random.RandomState(12)
    pts = torch.tensor(rng.uniform(0.02, 0.98, (32, jm.net_in)).astype(
        np.float32))
    w = torch.tensor(rng.standard_normal(32).astype(np.float32))

    def loss_fn(p):
        return torch.mean(tm.u(p, pts, nz) * w)

    def batched(sp):
        return torch.mean(tm.u_stacked(tm.prepare_params_stacked(sp, nz), pts)
                          * w, dim=-1)

    cfg = tzoo.SPSAConfig(num_samples=5, mu=0.01)
    state = tzoo.ZOState(step=3, seed=2)
    with torch.no_grad():
        g_seq, base_s = tzoo.spsa_gradient(
            tparams, counter_generator(state.seed, state.step), cfg,
            trainable_mask=mask, loss_fn=loss_fn)
        g_fused, base_f = tzoo.spsa_gradient(
            tparams, counter_generator(state.seed, state.step), cfg, batched,
            trainable_mask=mask)
        seq, _, _ = tzoo.zo_signsgd_step(tparams, state, 1e-2, cfg,
                                         loss_fn=loss_fn, trainable_mask=mask)
        fused, _, _ = tzoo.zo_signsgd_step(tparams, state, 1e-2, cfg, batched,
                                           trainable_mask=mask)
    np.testing.assert_allclose(float(base_s), float(base_f), rtol=1e-6)
    for gs, gf, a, b in zip(tzoo.tree_leaves(g_seq), tzoo.tree_leaves(g_fused),
                            tzoo.tree_leaves(seq), tzoo.tree_leaves(fused)):
        scale = float(gf.abs().max())
        np.testing.assert_allclose(gs.numpy(), gf.numpy(), rtol=0,
                                   atol=1e-3 * scale + 1e-9)
        # the sign steps agree wherever the sign is not in doubt
        sure = gf.abs() > 1e-3 * scale
        assert torch.equal(a[sure], b[sure])
