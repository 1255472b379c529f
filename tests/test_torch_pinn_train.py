"""The port's ZO-training paths of ``TensorPinn`` (stacked densification,
the stacked FD stencil, the losses) and the HJB residual against the JAX
package's.

Params, perturbation stacks and hardware noise come from the JAX side as
numpy trees and reach the port through ``repro_torch.interop``; query
points are made with numpy from a seed.  Tolerances: stencil u-values
``rtol=1e-5, atol=1e-6`` (the same f32 chain summed in another order, sin
from two libraries); losses ``rtol=1e-1`` — the FD residual squares second
differences, so the u-values' last-ulp differences grow by 1/h² = 1e4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pde as jpde
from repro.core import pinn as jpinn
from repro.core import stein as jstein
from repro.core import zoo as jzoo
from repro.core.photonic import NoiseModel as JNoise
from repro_torch import interop
from repro_torch import pde as tpde
from repro_torch.core import pinn as tpinn
from repro_torch.core import stein as tstein
from repro_torch.core import zoo as tzoo
from test_torch_pinn import RTOL, ATOL, _jax_solver, _np_tree, _points, \
    _port_model, share_cores

# label -> (mode, noise, hidden, tt_L, P, B): reduced widths at P 4, B 8,
# and the paper's spec at P 3, B 4
STACK_CASES = {
    "tt-reduced": ("tt", False, 64, 3, 4, 8),
    "tonn-reduced": ("tonn", False, 64, 3, 4, 8),
    "tonn-noise-reduced": ("tonn", True, 64, 3, 4, 8),
    "tonn-noise-paper": ("tonn", True, 1024, 4, 3, 4),
}
# the loss comparison averages the FD noise over a larger batch: a 1-ulp
# difference in u ≈ 10 moves each second difference by ~0.02 (1/h² = 1e4),
# ~0.1 summed over the 20-dim Laplacian, so at B = 8 two correct f32 paths
# differ by ~20% (a float64 evaluation of the same step sits between them)
LOSS_BATCH = 96


def _stacked_setup(label, fused, batch=None):
    """A JAX solver, a JAX-drawn perturbation stack and a collocation batch
    as numpy, the same arrays for both packages."""
    mode, noise, hidden, tt_L, P, B = STACK_CASES[label]
    cfg = jpinn.PINNConfig(hidden=hidden, mode=mode, tt_rank=2, tt_L=tt_L,
                           pde="hjb-20d", deriv="fd_fast",
                           use_fused_kernel=fused, noise=JNoise(enabled=noise))
    jm = jpinn.TensorPinn(cfg)
    key = jax.random.PRNGKey(len(label))
    params = jm.init(key)
    hw = jm.sample_noise(jax.random.fold_in(key, 99))
    mask = jm.trainable_mask(params)
    xis = jzoo.sample_perturbations(jax.random.fold_in(key, 5), params, P - 1,
                                    mask)
    stacked = jax.tree.map(
        lambda p, z: p + 0.01 * jnp.concatenate([jnp.zeros_like(z[:1]), z]),
        params, xis)
    xt = _points(batch or B, jm.net_in, seed=B)
    return cfg, jm, _np_tree(stacked), _np_tree(hw), xt


@pytest.mark.parametrize("label", sorted(STACK_CASES))
def test_fd_u_stencil_stacked_matches_jax(label):
    """The stacked stencil u-values against JAX's unfused path
    (``use_fused_kernel=False``: the same TT chain and libm sin)."""
    cfg, jm, stacked, hw, xt = _stacked_setup(label, fused=False)
    jprep = jm.prepare_params_stacked(jax.tree.map(jnp.asarray, stacked),
                                      hw and jax.tree.map(jnp.asarray, hw))
    want = np.asarray(jm.fd_u_stencil_stacked(jprep, jnp.asarray(xt),
                                              jm.fd_step))
    tm = _port_model(cfg)
    tprep = tm.prepare_params_stacked(
        interop.params_from_numpy(stacked, "cpu"),
        interop.noise_from_numpy(hw, "cpu"))
    got = tm.fd_u_stencil_stacked(tprep, torch.tensor(xt), tm.fd_step)
    P, B = STACK_CASES[label][4:]
    assert tuple(got.shape) == (P, 2 * tm.in_dim + 1, B)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    # entry p is the single-model stencil of the p-th params
    single = tm.fd_u_stencil(
        interop.params_from_numpy(jax.tree.map(lambda a: a[2], stacked),
                                  "cpu"), torch.tensor(xt), tm.fd_step,
        interop.noise_from_numpy(hw, "cpu"))
    np.testing.assert_allclose(single.numpy(), got[2].numpy(), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(
        tm.u_stacked(tprep, torch.tensor(xt)).numpy(),
        np.asarray(jm.u_stacked(jprep, jnp.asarray(xt))), rtol=RTOL,
        atol=1e-6)


@pytest.mark.parametrize("label", sorted(STACK_CASES))
def test_stacked_losses_match_jax_at_the_fd_noise_floor(label):
    """(P,) losses against JAX's fused config in ref mode (Kronecker head,
    polynomial sin): the FD residual amplifies their f32 differences by
    1/h² = 1e4, so rtol 1e-1 over ``LOSS_BATCH`` points."""
    cfg, jm, stacked, hw, xt = _stacked_setup(label, fused=True,
                                              batch=LOSS_BATCH)
    want = np.asarray(jpinn.residual_losses_stacked(
        jm, jax.tree.map(jnp.asarray, stacked), jnp.asarray(xt),
        hw and jax.tree.map(jnp.asarray, hw)))
    tm = _port_model(cfg)
    got = tpinn.residual_losses_stacked(
        tm, interop.params_from_numpy(stacked, "cpu"), torch.tensor(xt),
        interop.noise_from_numpy(hw, "cpu"))
    assert tuple(got.shape) == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-1)
    # the single-model losses (fd_fast and fd) agree with entry 0
    p0 = interop.params_from_numpy(jax.tree.map(lambda a: a[0], stacked),
                                   "cpu")
    nz = interop.noise_from_numpy(hw, "cpu")
    np.testing.assert_allclose(
        float(tpinn.residual_loss(tm, p0, torch.tensor(xt), nz)),
        float(got[0]), rtol=1e-1)
    fd = tpinn.TensorPinn(tpinn.PINNConfig(**{
        **tpinn.config_to_meta(tm.cfg), "deriv": "fd",
        "noise": tm.cfg.noise, "quant": tm.cfg.quant}))
    np.testing.assert_allclose(
        float(tpinn.residual_loss(fd, p0, torch.tensor(xt), nz)),
        float(got[0]), rtol=1e-1)


def test_trainable_mask_matches_jax():
    for mode in ("tt", "tonn"):
        cfg, jm, params, _ = _jax_solver("hjb-20d", mode, True, 64, 3)
        tm = _port_model(cfg)
        tmask = tm.trainable_mask(interop.params_from_numpy(_np_tree(params),
                                                            "cpu"))
        jmask = jm.trainable_mask(params)
        assert tzoo.tree_leaves(tmask) == [bool(b) for b in
                                           jax.tree.leaves(jmask)]
        assert jax.tree.structure(tmask) == jax.tree.structure(jmask)
        assert (False in tzoo.tree_leaves(tmask)) == (mode == "tonn")


def test_hjb_residual_of_the_exact_solution_is_under_its_tolerance():
    """The f32 FD estimate of the exact solution's residual stays under
    hjb's ``residual_tol``, and the residual matches JAX's on the same
    estimate."""
    tp, jp = tpde.get_problem("hjb-20d"), jpde.get_problem("hjb-20d")
    assert (tp.residual_tol, tp.fd_step, tp.has_boundary_loss) == \
        (jp.residual_tol, jp.fd_step, jp.has_boundary_loss)
    xt = torch.tensor(_points(64, tp.in_dim, seed=3))
    est = tstein.fd_estimate(tp.exact_solution, xt, h=tp.fd_step,
                             n_active=tp.in_dim)
    r = tp.residual(tp.scale_estimate(est), xt)
    assert float(torch.mean(r * r)) < tp.residual_tol
    jest = jstein.DerivativeEstimate(u=jnp.asarray(est.u.numpy()),
                                     grad=jnp.asarray(est.grad.numpy()),
                                     hess_diag=jnp.asarray(
                                         est.hess_diag.numpy()))
    np.testing.assert_allclose(
        r.numpy(), np.asarray(jp.residual(jest, jnp.asarray(xt.numpy()))),
        rtol=RTOL, atol=ATOL)
    assert tstein.num_fd_inferences(21) == jstein.num_fd_inferences(21) == 43


def test_fd_stencil_and_estimate_match_jax():
    xt = _points(5, 21, seed=8)
    np.testing.assert_allclose(
        tpde.fd_stencil_points(torch.tensor(xt), 1e-2, 21).numpy(),
        np.asarray(jpde.fd_stencil_points(jnp.asarray(xt), 1e-2, 21)),
        rtol=0, atol=0)
    vals = np.random.RandomState(0).standard_normal((43, 5)).astype(
        np.float32)
    got = tpde.estimate_from_u_stencil(torch.tensor(vals), 1e-2)
    want = jpde.estimate_from_u_stencil(jnp.asarray(vals), 1e-2)
    for leaf in ("u", "grad", "hess_diag"):
        np.testing.assert_allclose(getattr(got, leaf).numpy(),
                                   np.asarray(getattr(want, leaf)),
                                   rtol=RTOL, atol=1e-3)
    # a leading stack axis assembles entry by entry
    stacked = tpde.estimate_from_u_stencil(torch.tensor(vals)[None], 1e-2)
    assert torch.equal(stacked.hess_diag[0], got.hess_diag)


def test_loss_terms_and_weights_match_jax():
    tp, jp = tpde.get_problem("hjb-20d"), jpde.get_problem("hjb-20d")
    assert [(t.name, t.kind, t.weight) for t in tp.loss_terms()] == \
        [(t.name, t.kind, t.weight) for t in jp.loss_terms()]
    assert tp.term_weights() == jp.term_weights() == {"residual": 1.0}
    tp.set_term_weights({"residual": 2.0})
    assert tp.term_weights() == {"residual": 2.0}
    assert tpde.get_problem("hjb-20d").term_weights() == {"residual": 1.0}
    with pytest.raises(ValueError, match="unknown loss term"):
        tp.set_term_weights({"boundary": 1.0})
    with pytest.raises(NotImplementedError, match="defines no residual"):
        tpde.PDEProblem().residual(None, None)


def test_unported_estimators_raise():
    """Every estimator of the reference is ported (Stein is held to it in
    ``tests/test_torch_pde.py``, spectral in ``tests/test_torch_spectral.py``):
    a name neither package has raises, and spectral gives a finite loss."""
    def loss(deriv):
        tm = tpinn.TensorPinn(tpinn.PINNConfig(hidden=16, mode="tt", tt_L=3,
                                               deriv=deriv))
        p = tm.init(torch.Generator().manual_seed(0))
        return tpinn.residual_loss(tm, p, torch.full((2, 21), 0.5))

    with pytest.raises(ValueError, match="unknown derivative estimator"):
        loss("adjoint")
    assert torch.isfinite(loss("spectral"))


def test_validation_mse_matches_jax():
    cfg, jm, params, hw = _jax_solver("hjb-20d", "tonn", True, 64, 3, seed=4)
    xt = _points(50, 21, seed=9)
    want = float(jpinn.validation_mse(jm, params, jnp.asarray(xt), hw))
    got = float(tpinn.validation_mse(
        _port_model(cfg), interop.params_from_numpy(_np_tree(params), "cpu"),
        torch.tensor(xt), interop.noise_from_numpy(_np_tree(hw), "cpu")))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_per_term_losses_and_the_term_plan():
    tm = tpinn.TensorPinn(tpinn.PINNConfig(hidden=16, mode="tt", tt_L=3,
                                           deriv="fd_fast"))
    p = tm.init(torch.Generator().manual_seed(0))
    xt = torch.tensor(_points(6, 21, seed=2))
    terms = tpinn.per_term_losses(tm, p, xt, term_batches={})
    assert set(terms) == {"residual"}
    assert torch.equal(terms["residual"], tpinn.residual_loss(tm, p, xt))
    with pytest.raises(ValueError, match="unknown loss term"):
        tpinn.residual_loss(tm, p, xt, term_batches={"boundary": (xt, xt)})
    tm.problem.set_term_weights({"residual": 3.0})
    np.testing.assert_allclose(float(tpinn.residual_loss(tm, p, xt)),
                               3.0 * float(terms["residual"]), rtol=1e-6)
