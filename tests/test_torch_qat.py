"""Quantization-aware training in the port against the JAX package: the
``quant=`` hooks of ``TensorPinn`` (QAT stencils and stacked losses, the
disabled config's bit-identity, phase bits alone), a QAT ZO step, and the
trainer's ``--quant`` / ``--quant-block`` / ``--phase-bits`` flags.

Params, perturbation stacks and hardware noise come from the JAX side as
numpy trees (``repro_torch.interop``).  Tolerances: QAT stencil u-values
``rtol = 1e-5, atol = 1e-6`` (bit-equal cores, the chain's f32 sums in
another order); losses ``rtol = 1e-1`` over 96 points, the FD noise floor
(1/h² = 1e4 amplifies last-ulp differences of u).
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pinn as jpinn
from repro.core import zoo as jzoo
from repro.core.photonic import NoiseModel as JNoise
from repro.kernels import quant as jq
from repro_torch import interop
from repro_torch.checkpoint import read_checkpoint_meta
from repro_torch.core import photonic as tph
from repro_torch.core import pinn as tpinn
from repro_torch.core import zoo as tzoo
from repro_torch.device import counter_generator
from repro_torch.kernels import quant as tq
from repro_torch.kernels import ref as tref
from repro_torch.launch import train
from test_torch_quant import RTOL, CPU, _np_tree, _points, _port_model
from test_torch_pinn import share_cores  # noqa: F401 (autouse)

def _jax_qat(mode, qkw, noise, hidden=64, tt_L=3, fused=False, seed=0):
    cfg = jpinn.PINNConfig(hidden=hidden, mode=mode, tt_rank=2, tt_L=tt_L,
                           pde="hjb-20d", deriv="fd_fast",
                           use_fused_kernel=fused, noise=JNoise(enabled=noise),
                           quant=jq.QuantConfig(**qkw))
    model = jpinn.TensorPinn(cfg)
    key = jax.random.PRNGKey(seed)
    params = model.init(key)
    hw = model.sample_noise(jax.random.fold_in(key, 99))
    return cfg, model, params, hw


def _jax_stack(model, params, P, seed):
    """The base params and P-1 SPSA perturbations of them, stacked."""
    key = jax.random.PRNGKey(seed)
    xis = jzoo.sample_perturbations(key, params, P - 1,
                                    model.trainable_mask(params))
    return jax.tree.map(
        lambda p, z: p + 0.01 * jnp.concatenate([jnp.zeros_like(z[:1]), z]),
        params, xis)


@pytest.mark.parametrize("mode", ["tt", "tonn"])
def test_disabled_quant_config_is_bit_identical_to_the_default(mode):
    """A QuantConfig with ``enabled`` False but a dtype and phase bits set
    changes nothing: u, stencils and stacked losses are the same bits as
    the default config's."""
    base = tpinn.PINNConfig(hidden=64, mode=mode, tt_L=3, deriv="fd_fast",
                            use_fused_kernel=True,
                            noise=tph.NoiseModel(enabled=mode == "tonn"))
    off = dataclasses.replace(base, quant=tq.QuantConfig(
        enabled=False, dtype="fp8_e4m3", block=16, phase_bits=4))
    m0, m1 = tpinn.TensorPinn(base), tpinn.TensorPinn(off)
    params = m0.init(counter_generator(0))
    noise = m0.sample_noise(counter_generator(0, 99))
    xt = m0.problem.sample_collocation(counter_generator(1), 12)
    xis = tzoo.sample_perturbations(counter_generator(2), params, 3,
                                    m0.trainable_mask(params))
    stacked = tzoo.perturbed_stack(params, xis, tzoo.SPSAConfig(num_samples=3))
    with torch.no_grad():
        assert torch.equal(m0.u(params, xt, noise), m1.u(params, xt, noise))
        assert torch.equal(m0.fd_u_stencil(params, xt, m0.fd_step, noise),
                           m1.fd_u_stencil(params, xt, m1.fd_step, noise))
        assert torch.equal(
            tpinn.residual_losses_stacked(m0, stacked, xt, noise),
            tpinn.residual_losses_stacked(m1, stacked, xt, noise))


# label -> (mode, quant kwargs, noise, hidden, tt_L)
QAT_CASES = {
    "tt-int8": ("tt", dict(enabled=True), False, 64, 3),
    "tt-fp8-b16": ("tt", dict(enabled=True, dtype="fp8_e4m3", block=16),
                   False, 64, 3),
    "tonn-noise-int8-pb6": ("tonn", dict(enabled=True, phase_bits=6), True,
                            64, 3),
    "tonn-noise-fp8-pb6": ("tonn", dict(enabled=True, dtype="fp8_e4m3",
                                        phase_bits=6), True, 64, 3),
    "tonn-pb6-only": ("tonn", dict(enabled=True, dtype=None, phase_bits=6),
                      False, 64, 3),
    "tonn-noise-int8-pb8-paper": ("tonn", dict(enabled=True, phase_bits=8),
                                  True, 1024, 4),
}


@pytest.mark.parametrize("label", sorted(QAT_CASES))
def test_qat_stencil_u_matches_jax(label):
    """The stacked QAT stencil u-values (P = 3) against JAX's stacked
    path with the same params, perturbations and noise: strict."""
    mode, qkw, noise, hidden, tt_L = QAT_CASES[label]
    cfg, jm, params, hw = _jax_qat(mode, qkw, noise, hidden, tt_L,
                                   seed=len(label))
    stacked = _jax_stack(jm, params, 3, seed=5)
    xt = _points(4, 21, seed=len(label))
    jprep = jm.prepare_params_stacked(stacked, hw)
    want = np.asarray(jm.fd_u_stencil_stacked(jprep, jnp.asarray(xt),
                                              jm.fd_step))
    tm = _port_model(cfg)
    tprep = tm.prepare_params_stacked(
        interop.params_from_numpy(_np_tree(stacked), CPU),
        interop.noise_from_numpy(_np_tree(hw), CPU))
    got = tm.fd_u_stencil_stacked(tprep, torch.tensor(xt), tm.fd_step)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    # the single-model QAT forward of entry 0 against JAX's
    p0 = jax.tree.map(lambda a: a[0], stacked)
    np.testing.assert_allclose(
        tm.u(interop.params_from_numpy(_np_tree(p0), CPU),
             torch.tensor(xt), interop.noise_from_numpy(_np_tree(hw),
                                                        CPU)).numpy(),
        np.asarray(jm.u(p0, jnp.asarray(xt), hw)), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("label", ["tt-int8", "tonn-noise-fp8-pb6",
                                   "tonn-noise-int8-pb6"])
def test_qat_stacked_losses_match_jax_at_the_fd_noise_floor(label):
    """(P,) QAT losses over 96 points against JAX's fused config (ref
    mode), at the FD noise floor."""
    mode, qkw, noise, hidden, tt_L = QAT_CASES[label]
    cfg, jm, params, hw = _jax_qat(mode, qkw, noise, hidden, tt_L,
                                   fused=True, seed=len(label))
    stacked = _jax_stack(jm, params, 4, seed=6)
    xt = _points(96, 21, seed=3)
    want = np.asarray(jpinn.residual_losses_stacked(jm, stacked,
                                                    jnp.asarray(xt), hw))
    tm = _port_model(cfg)
    got = tpinn.residual_losses_stacked(
        tm, interop.params_from_numpy(_np_tree(stacked), CPU),
        torch.tensor(xt), interop.noise_from_numpy(_np_tree(hw), CPU))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-1)


def test_phase_bits_alone_keep_the_unquantized_chain(monkeypatch):
    """``--phase-bits`` without ``--quant`` has dtype None: the chain is
    the f32 one (kernel #2 on the card), not the quantized one."""
    def refuse(*args, **kwargs):
        raise AssertionError("the quantized chain ran")

    monkeypatch.setattr(tref, "tt_contract_batched_quant_ref", refuse)
    monkeypatch.setattr(tq, "fake_quant", refuse)
    tm = tpinn.TensorPinn(tpinn.PINNConfig(
        hidden=16, mode="tonn", tt_L=3, deriv="fd_fast",
        quant=tq.QuantConfig(enabled=True, dtype=None, phase_bits=4)))
    params = tm.init(counter_generator(0))
    stacked = tzoo.tree_map(lambda t: t[None].repeat_interleave(2, 0),
                            params)
    xt = tm.problem.sample_collocation(counter_generator(1), 5)
    assert torch.isfinite(tpinn.residual_losses_stacked(tm, stacked,
                                                        xt)).all()
    assert torch.isfinite(tm.u(params, xt)).all()


def test_qat_zo_step_keeps_the_buffers_frozen():
    cfg = tpinn.PINNConfig(hidden=64, mode="tonn", tt_L=3, deriv="fd_fast",
                           use_fused_kernel=True,
                           noise=tph.NoiseModel(enabled=True),
                           quant=tq.QuantConfig(enabled=True, phase_bits=8))
    model = tpinn.TensorPinn(cfg)
    params = model.init(counter_generator(0))
    noise = model.sample_noise(counter_generator(0, 99))
    mask = model.trainable_mask(params)
    xt = model.problem.sample_collocation(counter_generator(1), 16)
    new, _, loss = tzoo.zo_signsgd_step(
        params, tzoo.ZOState(step=0, seed=1), 1e-2,
        tzoo.SPSAConfig(num_samples=4),
        lambda sp: tpinn.residual_losses_stacked(model, sp, xt, noise),
        trainable_mask=mask)
    assert np.isfinite(float(loss))
    for a, b, trainable in zip(tzoo.tree_leaves(new),
                               tzoo.tree_leaves(params),
                               tzoo.tree_leaves(mask)):
        assert torch.equal(a, b) != trainable


# --------------------------------------------------------------- trainer

QAT_ARGS = ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--reduced",
            "--device", "cpu", "--log-every", "100", "--pinn-noise",
            "--quant", "int8", "--phase-bits", "8"]


def test_qat_trainer_writes_the_quant_config_and_resumes(tmp_path, capsys):
    args = QAT_ARGS + ["--steps", "6", "--batch", "8", "--zo-samples", "4",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    full = train.main(args)
    assert "quant=int8b32+pb8" in capsys.readouterr().out
    assert full.model.cfg.quant == tq.QuantConfig(enabled=True,
                                                  phase_bits=8)
    assert np.isfinite(full.losses).all() and np.isfinite(full.val_mse)
    meta = read_checkpoint_meta(tmp_path)
    assert meta["pinn"]["quant"] == {"enabled": True, "dtype": "int8",
                                     "block": 32, "phase_bits": 8}
    assert jpinn.config_from_meta(meta["pinn"]).quant == \
        jq.QuantConfig(enabled=True, phase_bits=8)
    shutil.rmtree(tmp_path / "step_000000000006")       # the cut
    resumed = train.main(args + ["--resume"])
    assert resumed.losses == full.losses[3:]
    for a, b in zip(tzoo.tree_leaves(resumed.params),
                    tzoo.tree_leaves(full.params)):
        assert torch.equal(a, b)


def test_fp8_and_block_flags_reach_the_config():
    res = train.main(QAT_ARGS[:-4] + ["--quant", "fp8_e4m3", "--quant-block",
                                      "16", "--steps", "2", "--batch", "8",
                                      "--zo-samples", "2"])
    assert res.model.cfg.quant == tq.QuantConfig(
        enabled=True, dtype="fp8_e4m3", block=16)
    assert np.isfinite(res.losses).all()
    res = train.main(QAT_ARGS[:-4] + ["--phase-bits", "6", "--steps", "1",
                                      "--batch", "8", "--zo-samples", "2"])
    assert res.model.cfg.quant.tag() == "pb6"
