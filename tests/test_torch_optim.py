"""The port's first-order optimizers (``repro_torch.optim``) against the JAX
package's, on the PINN's param trees.

The same params and gradients, made with numpy from a seed, go through
three ``update`` steps of both packages; new params and every state leaf
must agree within ``rtol = 1e-6`` (plus ``atol = 1e-9`` for values near
0): the same f32 operations in the same order, with ``pow`` / ``sqrt`` /
``rsqrt`` from two libraries.  The state trees must match key for key,
shape for shape and dtype for dtype, so that a checkpoint's ``opt``
subtree crosses between the packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pinn as jpinn
from repro.core.photonic import NoiseModel as JNoise
from repro.optim import optimizers as jopt
from repro_torch import interop
from repro_torch.core import zoo as tzoo
from repro_torch.optim import optimizers as topt

RTOL, ATOL = 1e-6, 1e-9
STEPS = 3


def _jax_params(mode):
    cfg = jpinn.PINNConfig(hidden=16, mode=mode, tt_L=3, pde="hjb-20d",
                           noise=JNoise(enabled=mode == "tonn"))
    return jpinn.TensorPinn(cfg).init(jax.random.PRNGKey(4))


def _grads(params, step):
    rng = np.random.RandomState(100 + step)
    return jax.tree.map(
        lambda p: (rng.standard_normal(np.shape(p)) * 0.1).astype(np.float32),
        params)


def _to_port(tree):
    """A numpy / jax tree (f32 and int32 leaves) as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_port(v) for v in tree]
    return torch.tensor(np.asarray(tree))


def _assert_tree_close(port_tree, jax_tree):
    j_leaves, j_def = jax.tree.flatten(jax_tree)
    p_leaves = tzoo.tree_leaves(port_tree)
    assert len(p_leaves) == len(j_leaves)
    for got, want in zip(p_leaves, j_leaves):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        assert str(got.numpy().dtype) == str(want.dtype)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["tt", "tonn"])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_update_matches_jax_for_three_steps(name, mode):
    jparams = _jax_params(mode)
    jo, to = jopt.get_optimizer(name), topt.get_optimizer(name)
    jstate = jo.init(jparams)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    tstate = to.init(tparams)
    _assert_tree_close(tstate, jstate)
    for step in range(STEPS):
        g = _grads(jparams, step)
        jparams, jstate = jo.update(jax.tree.map(jnp.asarray, g), jstate,
                                    jparams)
        tparams, tstate = to.update(_to_port(g), tstate, tparams)
        _assert_tree_close(tparams, jparams)
        _assert_tree_close(tstate, jstate)
    if name != "sgd":
        assert int(tstate["count"]) == STEPS
        assert tstate["count"].dtype == torch.int32


def test_adafactor_factors_the_last_two_axes():
    """A 4-D TT core keeps row statistics over its last axis and column
    statistics over the one before; vectors keep a full second moment."""
    params = {"core": torch.zeros(2, 3, 4, 5), "b": torch.zeros(7)}
    state = topt.adafactor().init(params)["v"]
    assert tuple(state["core"]["vr"].shape) == (2, 3, 4)
    assert tuple(state["core"]["vc"].shape) == (2, 3, 5)
    assert tuple(state["b"]["v"].shape) == (7,)


def test_get_optimizer_and_defaults_match_jax():
    """Names, the default learning rates and an ``lr`` given by the caller:
    one update of each against JAX's on the same gradients."""
    jparams = _jax_params("tt")
    g = _grads(jparams, 0)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    for name in ("adamw", "adafactor", "sgd"):
        for lr in (None, 0.05):
            jo, to = jopt.get_optimizer(name, lr), topt.get_optimizer(name, lr)
            assert to.name == jo.name
            want, _ = jo.update(jax.tree.map(jnp.asarray, g),
                                jo.init(jparams), jparams)
            got, _ = to.update(_to_port(g), to.init(tparams), tparams)
            _assert_tree_close(got, want)
    with pytest.raises(KeyError):
        topt.get_optimizer("lamb")
