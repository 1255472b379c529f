"""The port's zeroth-order optimizer against the JAX package's.

Given the ξ stack and the loss vector the JAX side made (handed over as
numpy), the reconstructed SPSA gradient and the sign-SGD update must match,
and the photonic ±1 buffers must stay bit-frozen.  JAX's threefry and
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
    with pytest.raises(NotImplementedError, match="item 6"):
        tzoo.spsa_gradient(tparams, counter_generator(0), cfg, None)
