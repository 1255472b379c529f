"""The port's trainer CLI (``repro_torch.launch.train``), its data streams
and its checkpoint manager, on the CPU.

A checkpoint the port writes is served by the JAX package's registry too
(noise off).  Tolerance for served u-values ``rtol = atol = 1e-5``: both
packages reassociate the f32 chain and take sin from two libraries.  With
noise on, the port's checkpoint carries the chip's noise, serves in the
port without it being passed (``rtol = atol = 1e-6`` against the
trainer's own ``u``: the same arithmetic on another batch size), and the
JAX package restores its params bit for bit.  Its meta records the seed as
``train_seed``: the JAX registry would redraw a noise-on chip from a
``seed`` with threefry and serve another chip, so it must refuse the
checkpoint instead.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.core import pinn as jpinn
from repro.serving import SolverRegistry as JRegistry
from repro_torch.checkpoint import CheckpointManager, read_checkpoint_meta
from repro_torch.core import pinn as tpinn
from repro_torch.core import zoo
from repro_torch.data import pde_collocation_iterator, pde_term_batch_iterator
from repro_torch.launch import train
from repro_torch.serving import PdeServingEngine, PointRequest, SolverRegistry
from test_torch_pinn import share_cores  # noqa: F401 (autouse)

REDUCED = ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--reduced",
           "--device", "cpu", "--log-every", "100"]


def _run(*extra):
    return train.main(REDUCED + [str(a) for a in extra])


def test_reduced_hjb_trains_to_a_falling_loss(capsys):
    """The paper's on-chip config (tonn, noise on) at the reduced width
    trains through the stacked path: finite losses falling, a finite val
    MSE, and the photonic buffers untouched."""
    res = _run("--steps", 24, "--batch", 16, "--zo-samples", 10,
               "--pinn-noise", "--lr", 1e-2, "--log-every", 8)
    assert len(res.losses) == 24 and np.isfinite(res.losses).all()
    assert np.median(res.losses[-5:]) < res.losses[0]
    assert res.val_mse is not None and np.isfinite(res.val_mse)
    init, _ = train.init_solver(res.model, 0)
    mask = res.model.trainable_mask(init)
    for new, old, trainable in zip(zoo.tree_leaves(res.params),
                                   zoo.tree_leaves(init),
                                   zoo.tree_leaves(mask)):
        assert torch.equal(new, old) != trainable
    out = capsys.readouterr().out
    assert "[pinn] pde=hjb-20d" in out and "mode=tonn" in out
    assert "step 16 loss" in out and "val MSE" in out
    assert "[train] done" in out


def test_checkpoint_serves_in_both_packages(tmp_path):
    res = _run("--steps", 4, "--batch", 8, "--zo-samples", 4,
               "--ckpt-dir", tmp_path, "--ckpt-every", 2)
    meta = read_checkpoint_meta(tmp_path)
    assert meta["step"] == 4 and meta["pde"] == "hjb-20d"
    assert meta["seed"] == 0 and meta["term_weights"] == {"residual": 1.0}
    assert meta["pinn"]["mode"] == "tonn" and meta["pinn"]["hidden"] == 64
    pts = np.random.RandomState(0).uniform(0.02, 0.98, (9, 21)).astype(
        np.float32)
    with torch.no_grad():
        want = res.model.u(res.params, torch.tensor(pts)).numpy()
    jax_solver = JRegistry().load_checkpoint("hjb", tmp_path)
    np.testing.assert_allclose(
        np.asarray(jax_solver.model.u(jax_solver.params, pts)), want,
        rtol=1e-5, atol=1e-5)
    reg = SolverRegistry(device="cpu")
    s = reg.load_checkpoint("hjb", tmp_path, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(
            s.model.u(s.params, torch.tensor(pts)).numpy(), want)


def _assert_trees_equal(jax_tree, torch_tree):
    if isinstance(torch_tree, dict):
        assert sorted(jax_tree) == sorted(torch_tree)
        for k in torch_tree:
            _assert_trees_equal(jax_tree[k], torch_tree[k])
    elif isinstance(torch_tree, (list, tuple)):
        assert len(jax_tree) == len(torch_tree)
        for a, b in zip(jax_tree, torch_tree):
            _assert_trees_equal(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(jax_tree), torch_tree.numpy())


def test_noise_on_checkpoint_serves_without_hw_noise(tmp_path):
    """The trainer saves the chip's noise beside the params: the noise-on
    checkpoint serves with no ``hw_noise=`` and gives the trainer's final
    ``model.u``; the JAX package still restores its params from it."""
    res = _run("--steps", 3, "--batch", 8, "--zo-samples", 4,
               "--pinn-noise", "--ckpt-dir", tmp_path)
    meta = read_checkpoint_meta(tmp_path)
    assert meta["step"] == 3 and meta["pinn"]["noise"]["enabled"]
    assert any(k.startswith("hw_noise/pcores0/") for k in meta["keys"])
    reg = SolverRegistry(device="cpu")
    reg.load_checkpoint("hjb", tmp_path, device="cpu")
    engine = PdeServingEngine(reg, slots=2, slot_points=16, device="cpu")
    pts = np.random.RandomState(3).uniform(0.02, 0.98, (37, 21)).astype(
        np.float32)
    req = engine.submit(PointRequest("hjb", pts))
    engine.run()
    with torch.no_grad():
        want = res.model.u(res.params, torch.tensor(pts),
                           res.hw_noise).numpy()
    np.testing.assert_allclose(req.out, want, rtol=1e-6, atol=1e-6)
    jmodel = jpinn.TensorPinn(jpinn.config_from_meta(meta["pinn"]))
    restored, _ = jax_restore(tmp_path, {
        "params": jmodel.init(jax.random.PRNGKey(0))})
    _assert_trees_equal(restored["params"], res.params)


def test_jax_registry_refuses_a_port_noise_checkpoint(tmp_path):
    """The JAX registry cannot rebuild the port's chip from a seed: a
    noise-on checkpoint written by the port records ``train_seed``, not
    ``seed``, so the JAX registry raises instead of serving a chip redrawn
    with threefry; the port's registry serves it from the saved noise."""
    res = _run("--steps", 2, "--batch", 8, "--zo-samples", 3,
               "--pinn-noise", "--ckpt-dir", tmp_path, "--seed", 4)
    meta = read_checkpoint_meta(tmp_path)
    assert "seed" not in meta and meta["train_seed"] == 4
    with pytest.raises(ValueError, match="training seed"):
        JRegistry().load_checkpoint("hjb", tmp_path)
    s = SolverRegistry(device="cpu").load_checkpoint("hjb", tmp_path,
                                                     device="cpu")
    pts = torch.tensor(np.random.RandomState(5).uniform(
        0.02, 0.98, (11, 21)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(
            s.model.u(s.params, pts).numpy(),
            res.model.u(res.params, pts, res.hw_noise).numpy(),
            rtol=1e-6, atol=1e-6)


def test_resume_redraws_the_same_perturbations(tmp_path):
    """A run cut after step_3 and resumed runs steps 3..5 as the
    uninterrupted run did: the same batches, the same ξ, the same params."""
    args = ("--steps", 6, "--batch", 8, "--zo-samples", 4,
            "--ckpt-dir", tmp_path, "--ckpt-every", 3)
    full = _run(*args)
    shutil.rmtree(tmp_path / "step_000000000006")      # the cut
    resumed = _run(*args, "--resume")
    assert resumed.losses == full.losses[3:]
    for a, b in zip(zoo.tree_leaves(resumed.params),
                    zoo.tree_leaves(full.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flags,item", [
    (["--pinn-mode", "onn", "--optimizer", "adamw", "--hidden", "1040"],
     "item 6c-3"),
    (["--estimator", "stein"], "reference trainer passes no PRNG key"),
    (["--coeff-range", "lam=0.05:0.1"], "need a coefficient-conditioned"),
    (["--coeff-dist", "uniform"], "need a coefficient-conditioned"),
    (["--coeffs-per-step", "2"], "needs a coefficient-conditioned"),
    (["--quant", "int8", "--pinn-mode", "onn"], "item 11"),
    (["--quant", "fp8_e4m3", "--quant-block", "16", "--pinn-mode", "onn"],
     "item 11"),
    (["--phase-bits", "8", "--pinn-mode", "onn"], "item 11"),
    (["--quant", "int8", "--optimizer", "adamw"], "item 11"),
    (["--phase-bits", "8", "--pinn-noise", "--optimizer", "sgd"], "item 11"),
    (["--seq", "16"], "item 14"),
    (["--compress-grads"], "item 14"), (["--zo-vectorized"], "item 14")])
def test_unported_flags_exit_with_their_roadmap_item(flags, item):
    """Each refusal names its ROADMAP item; ``--estimator stein`` names the
    reference trainer's own fault instead (it passes its Stein loss no
    PRNG key), which neither trainer takes.  The ``--coeff-*`` flags are
    ported: on hjb-20d, which is not conditioned, they exit saying so."""
    with pytest.raises(SystemExit, match=item):
        train.main(REDUCED + flags)


@pytest.mark.parametrize("flags", [["--shard", "perturbation"],
                                   ["--mesh", "2x1"], ["--async-ckpt"]])
def test_item_13_flags_train_in_one_process(flags, tmp_path, capsys):
    """The flags item 13 ported, where they need no spawned ranks: on the
    CPU ``--shard`` alone lays out one rank (the distributed step without
    collectives), ``--mesh`` without ``--shard`` is ignored as in the JAX
    trainer, ``--async-ckpt`` writes on a thread.  Each trains bit for bit
    as the plain run."""
    common = ["--steps", "3", "--batch", "8", "--pinn-noise"]
    plain = _run(*common)
    res = _run(*common, *flags, "--ckpt-dir", tmp_path)
    assert res.losses == plain.losses
    for a, b in zip(zoo.tree_leaves(res.params), zoo.tree_leaves(plain.params)):
        assert torch.equal(a, b)
    assert (tmp_path / "step_000000000003" / "COMMITTED").exists()
    layout = "[pinn] distributed ZO mesh pert=1 batch=1 (shard=perturbation)"
    assert (layout in capsys.readouterr().out) == ("--shard" in flags)


def test_onn_bp_trains_where_the_resident_backward_holds_its_meshes():
    """onn BP at hidden 64 (its 64- and 21-port meshes take the resident
    design's backward on the card) trains on the CPU: finite losses and
    val MSE, and it refuses only past 1024 ports, whose meshes take the
    owner walk (``pinn.onn_no_backward_ports``): the resident backward
    holds up to 138 ports, the warp-rows backward the rest."""
    res = train.main(REDUCED + ["--pinn-mode", "onn", "--pinn-noise",
                                "--optimizer", "adamw", "--steps", "2"])
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    assert np.isfinite(res.val_mse)
    cfg = res.model.cfg
    assert tpinn.onn_no_backward_ports(cfg) == []
    for hidden in (138, 140, 1024):
        assert tpinn.onn_no_backward_ports(dataclasses.replace(
            cfg, hidden=hidden)) == []
    assert tpinn.onn_no_backward_ports(dataclasses.replace(
        cfg, hidden=1040)) == [1040]


def test_onn_bp_trains_at_a_width_of_the_warp_rows_backward():
    """onn BP at hidden 144, whose hidden meshes the resident backward
    does not hold (on the card they take route A forward and the
    warp-rows backward), trains on the CPU: finite losses and val MSE,
    every trainable leaf moved."""
    res = train.main(REDUCED + ["--pinn-mode", "onn", "--pinn-noise",
                                "--optimizer", "adamw", "--hidden", "144",
                                "--steps", "2", "--batch", "16"])
    assert res.model.cfg.hidden == 144
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    assert np.isfinite(res.val_mse)
    init, _ = train.init_solver(res.model, 0)
    mask = res.model.trainable_mask(res.params)
    for a, b, m in zip(zoo.tree_leaves(res.params), zoo.tree_leaves(init),
                       zoo.tree_leaves(mask)):
        assert not m or not torch.equal(a, b)


def test_lm_archs_and_unported_pdes_are_refused():
    with pytest.raises(SystemExit, match="item 14"):
        train.main(["--arch", "qwen2.5-3b", "--device", "cpu"])
    with pytest.raises(KeyError, match="unknown PDE 'heat-30d'"):
        _run("--pde", "heat-30d", "--steps", 1)


def test_streams_are_counter_based():
    """A stream started at step k gives the batches an uninterrupted one
    gives from step k on; hjb has no boundary or data terms."""
    it = pde_collocation_iterator(5, seed=3, pde="hjb-20d")
    batches = [next(it) for _ in range(4)]
    later = pde_collocation_iterator(5, seed=3, start_step=2, pde="hjb-20d")
    assert torch.equal(next(later), batches[2])
    assert not torch.equal(batches[0], batches[1])
    assert tuple(batches[0].shape) == (5, 21)
    assert 0.02 <= float(batches[0].min()) and float(batches[0].max()) <= 0.98
    other = pde_collocation_iterator(5, seed=4, pde="hjb-20d")
    assert not torch.equal(next(other), batches[0])
    assert next(pde_term_batch_iterator(4, pde="hjb-20d")) == {}


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, save_every=5)
    assert [s for s in range(12) if mgr.should_save(s)] == [5, 10]
    for step in (1, 2, 3):
        mgr.save(step, {"a": torch.full((2,), float(step))}, {"step": step})
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000000002", "step_000000000003"]
    tree, meta = mgr.restore_latest({"a": torch.zeros(2)})
    assert meta["step"] == 3 and torch.equal(tree["a"], torch.full((2,), 3.0))
