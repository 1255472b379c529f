"""The port's runtime policy layer against the JAX package's: the straggler
watchdog's median + MAD classifier (window gating, patience firing and
reset, the wall-clock path), the ZO elastic controller's checkpoint-restore
bookkeeping, the asynchronous checkpoint against the synchronous one, and
the trainer's ``--async-ckpt`` with ``--resume``.

The counterpart of ``tests/test_runtime.py`` (its watchdog and ZO-elastic
cases) and of ``tests/test_checkpoint.py``'s async save and watchdog
policy.  Each watchdog case feeds the same synthetic step times to both
packages' watchdogs and compares every step's classification; the
elastic cases run on the one-rank layout (no process group), as the JAX
ones run on a 1×1 mesh.  ``ElasticController`` (the BP arm) is not ported
(ROADMAP item 14f).
"""

import numpy as np
import pytest
import torch

from repro.runtime import StragglerWatchdog as JWatchdog
from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.launch import train
from repro_torch.parallel import zo_shard
from repro_torch.runtime import StragglerWatchdog, ZOElasticController
from test_torch_pinn import share_cores  # noqa: F401 (autouse)


# ----------------------------------------------------------------- watchdog

def _feed(wd, durations, start=0):
    return [wd.end_step(start + i, duration_s=d)
            for i, d in enumerate(durations)]


def _both(**kw):
    """The port's watchdog and the JAX package's, each with its own list
    of fired steps."""
    fired, jfired = [], []
    return (StragglerWatchdog(on_straggle=fired.append, **kw), fired,
            JWatchdog(on_straggle=jfired.append, **kw), jfired)


def _same(stats, jstats):
    assert [(s.step, s.duration_s, s.median_s, s.is_straggler)
            for s in stats] == [(s.step, s.duration_s, s.median_s,
                                 s.is_straggler) for s in jstats]


def test_watchdog_needs_window_before_classifying():
    """The first 5 steps never classify, even an absurd outlier; the 6th
    does, and patience 1 fires at once."""
    wd, fired, jwd, jfired = _both(threshold=3.0, patience=1)
    durations = [0.1, 0.1, 0.1, 0.1, 100.0]
    stats = _feed(wd, durations)
    _same(stats, _feed(jwd, durations))
    assert not any(s.is_straggler for s in stats) and fired == []
    assert wd.end_step(5, duration_s=100.0).is_straggler
    assert jwd.end_step(5, duration_s=100.0).is_straggler
    assert len(fired) == len(jfired) == 1
    assert wd.straggles == 1


def test_watchdog_median_mad_classification():
    """median + threshold·MAD of the window before the step: just above
    the noise band is flagged, inside it is not."""
    wd, _, jwd, _ = _both(threshold=3.0, patience=10)
    durations = [0.10, 0.12, 0.11, 0.09, 0.10, 0.11, 0.10, 0.12, 0.115,
                 0.25]
    stats = _feed(wd, durations)
    _same(stats, _feed(jwd, durations))
    # median 0.105, MAD 0.005 -> cutoff 0.12
    assert not stats[8].is_straggler and stats[9].is_straggler
    assert stats[9].duration_s == 0.25 and 0.09 <= stats[9].median_s <= 0.13


def test_watchdog_patience_firing_and_reset():
    """The callback fires after ``patience`` consecutive stragglers, then
    resets; a clean step in between resets the count too."""
    wd, fired, jwd, jfired = _both(threshold=3.0, patience=3)
    seq = ([(i, 0.1) for i in range(8)]
           + [(10 + i, d) for i, d in enumerate([5.0, 5.0, 0.1, 5.0, 5.0])])
    for step, d in seq:
        wd.end_step(step, duration_s=d)
        jwd.end_step(step, duration_s=d)
    assert fired == [] and wd.consecutive == jwd.consecutive == 2
    st = wd.end_step(20, duration_s=5.0)
    jwd.end_step(20, duration_s=5.0)
    assert len(fired) == len(jfired) == 1 and fired[0] is st
    assert wd.consecutive == 0
    for wdog in (wd, jwd):
        _feed(wdog, [0.1] * 8, start=30)
        for i in range(3):
            wdog.end_step(40 + i, duration_s=5.0)
    assert len(fired) == len(jfired) == 2
    _same(wd.history, jwd.history)


def test_watchdog_wall_clock_path():
    """start_step/end_step without a duration measure elapsed time (the
    trainer's use)."""
    wd = StragglerWatchdog()
    wd.start_step()
    st = wd.end_step(0)
    assert st.duration_s >= 0 and wd.history == [st]


def test_straggler_watchdog_policy():
    """``tests/test_checkpoint.py``'s policy case, on both packages."""
    wd, fired, jwd, jfired = _both(window=20, threshold=3.0, patience=2)
    durations = [1.0 + 0.01 * (i % 3) for i in range(10)] + [5.0, 5.0]
    _same(_feed(wd, durations), _feed(jwd, durations))
    assert len(fired) == len(jfired) == 1 and fired[0].is_straggler
    for step, d in ((12, 1.0), (13, 5.0)):
        wd.end_step(step, duration_s=d)
        jwd.end_step(step, duration_s=d)
    assert len(fired) == len(jfired) == 1
    _same(wd.history, jwd.history)


# -------------------------------------------------------------- elastic

def _zo_mesh(n_ranks: int):
    # no process group: the one-rank layout for every "surviving" count
    # keeps the controller's bookkeeping the thing under test
    return zo_shard.make_zo_mesh("1x1")


def test_zo_elastic_resume_restores_tree_and_rebuilds_step(tmp_path):
    """The newest checkpoint restored bit-exact, the mesh and step rebuilt
    for the new rank count, the meta passed through."""
    mgr = CheckpointManager(tmp_path, keep=2, save_every=1)
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "zo": {"seed": torch.tensor(7), "step": torch.tensor(3)}}
    mgr.save(3, tree, {"step": 3, "lr": 1e-3})
    stale = {"params": {"w": torch.zeros(2, 3)},
             "zo": {"seed": torch.tensor(0), "step": torch.tensor(0)}}
    mgr.save(5, tree, {"step": 5, "lr": 5e-4})   # newest wins
    built = []
    ctrl = ZOElasticController(
        ckpt=mgr, make_mesh=_zo_mesh,
        build_step=lambda mesh: built.append(mesh) or (lambda *a: "step"))
    mesh, step_fn, restored, meta = ctrl.resume(4, stale)
    assert built == [mesh] and mesh.axis_names == ("pert", "batch")
    assert step_fn() == "step"
    assert meta["step"] == 5 and meta["lr"] == 5e-4
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert int(restored["zo"]["seed"]) == 7


def test_zo_elastic_resume_without_checkpoint_raises(tmp_path):
    """No complete checkpoint: the restore raises; nothing is invented."""
    ctrl = ZOElasticController(
        ckpt=CheckpointManager(tmp_path, keep=2),
        make_mesh=_zo_mesh, build_step=lambda mesh: lambda *a: None)
    with pytest.raises(FileNotFoundError):
        ctrl.resume(2, {"params": {"w": torch.zeros(2)}})


def test_zo_elastic_repeated_resizes_bookkeeping(tmp_path):
    """Shrink then grow: one rebuild a resize, each restoring the newest
    checkpoint at that moment."""
    mgr = CheckpointManager(tmp_path, keep=3, save_every=1)
    like = {"params": {"w": torch.zeros(3)}}
    mgr.save(1, {"params": {"w": torch.ones(3)}}, {"step": 1})
    builds = []
    ctrl = ZOElasticController(
        ckpt=mgr, make_mesh=_zo_mesh,
        build_step=lambda mesh: builds.append(mesh) or (lambda *a: None))
    _, _, t1, m1 = ctrl.resume(8, like)
    mgr.save(2, {"params": {"w": torch.full((3,), 2.0)}}, {"step": 2})
    _, _, t2, m2 = ctrl.resume(4, like)
    assert len(builds) == 2
    assert (m1["step"], m2["step"]) == (1, 2)
    assert torch.equal(t1["params"]["w"], torch.ones(3))
    assert torch.equal(t2["params"]["w"], torch.full((3,), 2.0))


# ------------------------------------------------------- async checkpoints

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32),
                       "c": [torch.ones(3), torch.zeros(2, 2)]}}


def test_async_save_matches_sync(tmp_path):
    """An async save writes the same files as a synchronous one, of the
    tree as it was at ``save``: later in-place updates do not reach it."""
    t = _tree(3)
    want = {"a": t["a"].clone()}
    mgr = CheckpointManager(tmp_path / "async", keep=3, save_every=1,
                            async_save=True)
    mgr.save(5, t, {"step": 5})
    t["a"].add_(1.0)                   # the trainer goes on
    mgr.wait()
    save_checkpoint(tmp_path / "sync", 5, {**t, "a": want["a"]},
                    {"step": 5})
    restored, meta = restore_checkpoint(tmp_path / "async", _tree())
    assert meta["step"] == 5
    assert torch.equal(restored["a"], want["a"])
    for name in ("async", "sync"):
        assert (tmp_path / name / "step_000000000005" / "COMMITTED").exists()
    a = np.load(tmp_path / "async" / "step_000000000005" / "arrays.npz")
    b = np.load(tmp_path / "sync" / "step_000000000005" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_async_save_keeps_k_and_raises_a_failed_write(tmp_path):
    """Async saves keep the newest k; a write that fails raises at the
    next ``wait`` (or save, or restore) instead of passing."""
    mgr = CheckpointManager(tmp_path / "ok", keep=2, save_every=1,
                            async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, _tree(s))
    restored, meta = mgr.restore_latest(_tree())     # waits first
    assert meta["step"] == 3
    assert sorted(p.name for p in (tmp_path / "ok").iterdir()) == [
        "step_000000000002", "step_000000000003"]
    (tmp_path / "file").write_text("not a directory")
    bad = CheckpointManager(tmp_path / "file", async_save=True)
    bad.save(1, _tree())
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        bad.wait()
    bad.wait()                         # the error is raised once


def test_cli_async_ckpt_resume_continues_from_the_checkpoint(tmp_path,
                                                             capsys):
    """``--async-ckpt`` checkpoints on a thread; ``--resume`` continues
    from the newest one: the same losses and params as one uninterrupted
    run."""
    base = ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--reduced",
            "--pinn-noise", "--batch", "16", "--log-every", "4",
            "--device", "cpu", "--ckpt-every", "3"]
    full = train.main(base + ["--steps", "8"])
    first = train.main(base + ["--steps", "6", "--async-ckpt",
                               "--ckpt-dir", str(tmp_path)])
    rest = train.main(base + ["--steps", "8", "--async-ckpt", "--resume",
                              "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[resume] step 6" in out
    assert "[watchdog]" in out
    assert len(rest.losses) == 2
    np.testing.assert_array_equal(first.losses + rest.losses, full.losses)
    for a, b in zip(train.zoo.tree_leaves(rest.params),
                    train.zoo.tree_leaves(full.params)):
        assert torch.equal(a, b)
    steps = sorted(p.name for p in tmp_path.iterdir())
    assert steps == ["step_000000000003", "step_000000000006",
                     "step_000000000008"]
