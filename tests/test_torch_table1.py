"""The port's Table 1 (``benchmarks/torch_table1_hjb.py``) against the JAX
package's (``benchmarks/table1_hjb.py``), on the CPU.

The BP rows run from the JAX row's own draws (its initial params, chip
noise, the batch of every epoch and the validation points, written by
``benchmarks/table1_bar_reference.row_arrays`` and read back by
``load_arrays``), so only the arithmetic differs.  Tolerances: the loss is
a finite-difference residual whose second differences amplify the
u-values' last-ulp differences by 1/h² = 1e4, so two correct f32 paths
give loss gradients ~10% apart in relative L2 (``test_torch_bp.py``), and
20 plain gradient steps at lr 0.02 carry that into the params.  Measured
at hidden 16, ``tt_L`` 2, 20 epochs: each trained leaf's distance to
JAX's final leaf is at most 16% of how far JAX moved it (8% over all
leaves), the val MSEs at most 6.2% apart, the last loss 11%.  Held at
30% per leaf, 15% over all leaves, val MSE rtol 0.15 and the last loss
rtol 0.25 (``test_torch_bp.py``'s FD-floor tolerance).

The on-chip (ZO) row runs from the same draws plus JAX's ξ of every
epoch, with a smooth stacked loss in place of the FD residual in both
packages, so its arm (learning-rate schedule, mask, ξ stack, sign update)
is held to JAX's step for step: measured at hidden 16, ``tt_L`` 2, 20
epochs, every param equal to JAX's and the val MSEs 2e-7 apart.  With the
FD residual the runs part ways at the first step (20 of 317 entries take
another sign), because both packages' f32 losses sit 1–7% from the f64
loss (``table1_bar_reference.loss_floor``) and that noise sets the sign of
ĝ's small entries.
"""

import json

import jax
import numpy as np
import pytest
import torch

from benchmarks import table1_hjb as jtable
from benchmarks import torch_table1_hjb as ttable
from benchmarks.table1_bar_reference import loss_floor, row_arrays
from repro.core import pinn as jpinn
from repro_torch.core import pinn as tpinn
from repro_torch.core import zoo
from test_torch_pinn import share_cores  # noqa: F401 (autouse)

SMALL = dict(hidden=16, tt_L=2, epochs=20)


def _capture(monkeypatch, module) -> list:
    """Record the params every ``validation_mse`` call of ``module`` is
    given: a row's first call holds its trained params."""
    seen, orig = [], module.validation_mse

    def wrapped(model, params, xt, noise=None):
        seen.append(params)
        return orig(model, params, xt, noise)

    monkeypatch.setattr(module, "validation_mse", wrapped)
    return seen


def _jax_arrays(tmp_path, mode, noise, epochs, hidden, tt_L, seed=0):
    path = tmp_path / f"{mode}-{noise}.npz"
    np.savez(path, **row_arrays(seed, epochs, hidden, tt_L, mode=mode,
                                noise=noise))
    return ttable.load_arrays(str(path))


@pytest.mark.parametrize("key", [("tt", False, False), ("tt", False, True),
                                 ("dense", False, False)],
                         ids=lambda k: ttable.row_name(*k).split("/")[1])
def test_bp_row_matches_jax(key, monkeypatch, tmp_path):
    jseen = _capture(monkeypatch, jpinn)
    tseen = _capture(monkeypatch, tpinn)
    want = jtable.run_row(*key, **SMALL)
    arrays = _jax_arrays(tmp_path, want["mode"], key[2], **SMALL)
    got = ttable.run_row(*key, **SMALL, device="cpu", **arrays)

    assert set(got) - set(want) == {"ms_per_step"} and set(want) <= set(got)
    assert got["ms_per_step"] is None                  # no device time here
    for k in ("mode", "on_chip", "noise", "pde", "params"):
        assert got[k] == want[k], k
    for k in ("val_mse_ideal", "val_mse_mapped"):
        assert got[k] == pytest.approx(want[k], rel=0.15), k
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=0.25)

    init = [np.asarray(x) for x in zoo.tree_leaves(arrays["params0"])]
    jfin = [np.asarray(x) for x in jax.tree.leaves(jseen[0])]
    tfin = [x.numpy() for x in zoo.tree_leaves(tseen[0])]
    assert [a.shape for a in jfin] == [a.shape for a in tfin]
    moved = [np.linalg.norm(j - i) for j, i in zip(jfin, init)]
    apart = [np.linalg.norm(t - j) for t, j in zip(tfin, jfin)]
    for m, a in zip(moved, apart):
        assert a <= 0.3 * m                     # fixed leaves: both 0
    assert np.linalg.norm(apart) <= 0.15 * np.linalg.norm(moved)
    # the photonic ±1 diags and every other fixed buffer are bit-unchanged
    mask = zoo.tree_leaves(tpinn.TensorPinn(tpinn.PINNConfig(
        hidden=16, tt_L=2, mode=want["mode"])).trainable_mask(
            arrays["params0"]))
    for t, i, train in zip(tfin, init, mask):
        if not train:
            assert np.array_equal(t, i)


def test_onchip_row_matches_jax_with_its_xi(monkeypatch, tmp_path):
    """The proposed row's ZO arm from the JAX row's draws and ξ: the same
    params after 20 epochs.  A flipped sign moves an entry by 2·lr_t ≥
    1.3e-3, so atol 1e-6 catches one; val MSE rtol 1e-5 (measured 2e-7)."""
    import jax.numpy as jnp

    def fit(lib):
        def losses(model, stacked, xt, noise=None, **_):
            u = model.u_stacked(model.prepare_params_stacked(stacked, noise),
                                xt)
            return lib.mean((u - model.problem.exact_solution(xt)) ** 2,
                            axis=-1)
        return losses

    monkeypatch.setattr(jpinn, "residual_losses_stacked", fit(jnp))
    monkeypatch.setattr(tpinn, "residual_losses_stacked", fit(torch))
    jseen = _capture(monkeypatch, jpinn)
    tseen = _capture(monkeypatch, tpinn)
    want = jtable.run_row("tonn", True, True, **SMALL)
    path = tmp_path / "a.npz"
    np.savez(path, **row_arrays(0, SMALL["epochs"], SMALL["hidden"],
                                SMALL["tt_L"], xis=True))
    arrays = ttable.load_arrays(str(path))
    got = ttable.run_row("tonn", True, True, **SMALL, device="cpu", **arrays)

    for k in ("val_mse_ideal", "val_mse_mapped", "final_loss"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    init = [np.asarray(x) for x in zoo.tree_leaves(arrays["params0"])]
    jfin = [np.asarray(x) for x in jax.tree.leaves(jseen[0])]
    tfin = [x.numpy() for x in zoo.tree_leaves(tseen[0])]
    assert sum(not np.array_equal(j, i) for j, i in zip(jfin, init)) > 0
    for t, j in zip(tfin, jfin):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="on-chip"):
        ttable.run_row("tt", False, False, **SMALL, device="cpu",
                       xis=arrays["xis"])


def test_onchip_beats_offchip_mapping_under_noise():
    """Paper Table 1's ordering at CI scale, as the JAX package's
    ``test_system.py`` checks it: training ON the noisy hardware (ZO)
    must beat training off-chip and mapping onto the same noise."""
    kw = dict(hidden=32, epochs=250, tt_L=2, device="cpu")
    off = ttable.run_row("tonn", on_chip=False, noise=True, **kw)
    on = ttable.run_row("tonn", on_chip=True, noise=True, **kw)
    assert on["val_mse_mapped"] < off["val_mse_mapped"], (on, off)


def test_run_gives_the_jax_rows(monkeypatch):
    """``run()`` asks for JAX's four rows, in order, with the same
    arguments, and names them as JAX does."""
    calls = {"jax": [], "port": []}

    def stub(side):
        def run_row(mode, on_chip, noise, **kw):
            kw.pop("device", None)
            calls[side].append((mode, on_chip, noise, kw))
            return {"mode": mode}
        return run_row

    monkeypatch.setattr(jtable, "run_row", stub("jax"))
    monkeypatch.setattr(ttable, "run_row", stub("port"))
    jrows, trows = jtable.run(), ttable.run(device="cpu")
    assert calls["port"] == calls["jax"] and len(calls["jax"]) == 4
    assert [r["name"] for r in trows] == [r["name"] for r in jrows]
    assert [r["name"] for r in trows] == [
        "table1/tt-offchip-ideal", "table1/tt-offchip-noisy",
        "table1/tonn-onchip-noisy", "table1/dense-offchip-ideal"]


def test_offchip_onn_row_names_item_6c():
    """Past 1024 ports (hidden 1040) the off-chip ONN row's meshes take
    the owner walk, whose backward is item 6c-3: it refuses before any
    work, on every device.  At the paper's hidden 1024 the warp-rows
    backward holds its meshes, and the row runs."""
    with pytest.raises(NotImplementedError, match="item 6c-3"):
        ttable.run_row("dense", False, True, **{**SMALL, "hidden": 1040},
                       device="cpu")
    with pytest.raises(SystemExit, match="item 6c-3"):
        ttable.main(["--rows", "dense-offchip-noisy", "--device", "cpu",
                     "--hidden", "1040", "--out", "unused.json"])
    assert ttable.unported("onn", True, True) is None
    assert ttable.unported("dense", False, True, hidden=64) is None
    assert ttable.unported("dense", False, True, hidden=1024) is None


def test_offchip_onn_row_runs_at_hidden_16(tmp_path):
    """The off-chip ONN row (``dense`` mapped onto noise) trains onn by BP
    at a width the resident backward holds: finite val MSEs, its hidden
    width recorded, no kernel launched on the CPU."""
    out = tmp_path / "t1.json"
    res = ttable.main(["--hidden", "16", "--epochs", "3", "--rows",
                       "dense-offchip-noisy", "--device", "cpu", "--out",
                       str(out)])
    row, = res["rows"]
    assert row["name"] == "table1/dense-offchip-noisy" and row["mode"] == "onn"
    assert row["hidden"] == 16 and np.isfinite(row["val_mse_mapped"])
    assert np.isfinite(row["val_mse_ideal"])
    assert not any(row["launches"].values())


def test_cli_rows_on_the_cpu(tmp_path):
    """The CLI on the CPU: every row and seed written, no kernel launched
    (the CPU takes the plain versions), no device time."""
    out = tmp_path / "t1.json"
    res = ttable.main(["--hidden", "16", "--tt-L", "2", "--epochs", "2",
                       "--seeds", "0,1", "--rows",
                       "tt-offchip-ideal,tonn-onchip-noisy",
                       "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == {"runs": [json.loads(
        json.dumps(res))]}
    assert [(r["name"], r["seed"]) for r in res["rows"]] == [
        ("table1/tt-offchip-ideal", 0), ("table1/tt-offchip-ideal", 1),
        ("table1/tonn-onchip-noisy", 0), ("table1/tonn-onchip-noisy", 1)]
    for r in res["rows"]:
        assert np.isfinite(r["val_mse_mapped"]) and r["ms_per_step"] is None
        assert not any(r["launches"].values())
    assert res["device"] == {"type": "cpu", "kind": None, "nvidia_smi": None}


def test_bar_runs_seeds_and_the_shared_init_pair(tmp_path):
    """``--bar``: the proposed row per seed on the reference's validation
    points and the verdict; from the reference seed's own arrays, one run
    per seed of ξ and one with the reference's ξ; the port's initial
    losses beside the reference's f32 and f64 ones (within rtol 1e-1 of
    the f64 loss: the FD floor of ``test_torch_pinn_train.py``)."""
    arrays = tmp_path / "a.npz"
    np.savez(arrays, **row_arrays(0, 2, 16, 2, xis=True),
             **loss_floor(0, 1, 16, 2))
    ref = tmp_path / "ref.json"
    runs = [{"seed": s, "val_mse_mapped": v, "val_mse_ideal": v,
             "final_loss": 1.0, "seconds": 1.0} for s, v in ((0, 0.1),
                                                             (1, 5.0))]
    ref.write_text(json.dumps({"row": "table1/tonn-onchip-noisy",
                               "runs": runs}))
    argv = ["--hidden", "16", "--tt-L", "2", "--epochs", "2", "--seeds",
            "0,1", "--device", "cpu", "--bar", str(ref), str(arrays),
            "--out", str(tmp_path / "bar.json")]
    with pytest.raises(SystemExit, match="arrays_seed"):
        ttable.main(argv)                   # which seed drew the arrays?
    ref.write_text(json.dumps({"row": "table1/tonn-onchip-noisy",
                               "arrays_seed": 0, "runs": runs}))
    res = ttable.main(argv)
    port = [r["val_mse_mapped"] for r in res["rows"]]
    assert [r["name"] for r in res["rows"]] == \
        ["table1/tonn-onchip-noisy"] * 2
    verdict = res["bar"]["verdict"]
    assert verdict == ttable.bar_verdict(port, [0.1, 5.0])
    assert verdict["passed"] == (0.1 <= float(np.median(port)) <= 5.0)

    shared = res["bar"]["shared_init"]
    assert shared["arrays_seed"] == 0 and shared["reference"]["seed"] == 0
    loaded = ttable.load_arrays(str(arrays))
    own = {k: v for k, v in loaded.items() if k != "xis"}
    kw = dict(SMALL, epochs=2, device="cpu")
    assert [r["seed"] for r in shared["port_own_xi"]] == [0, 1]
    again = ttable.run_row("tonn", True, True, seed=1, **kw, **own)
    assert shared["port_own_xi"][1]["val_mse_mapped"] == \
        again["val_mse_mapped"]                 # seed sets only ξ here
    mapped = [r["val_mse_mapped"] for r in shared["port_own_xi"]]
    assert shared["xi_spread"] == {"min": min(mapped),
                                   "median": float(np.median(mapped)),
                                   "max": max(mapped)}
    again = ttable.run_row("tonn", True, True, **kw, **loaded)
    assert shared["port_reference_xi"]["val_mse_mapped"] == \
        again["val_mse_mapped"]
    assert again["val_mse_mapped"] != shared["port_own_xi"][0][
        "val_mse_mapped"]                    # the reference's ξ were used

    floor = shared["loss_floor"]
    assert len(floor["port_f32"]) == len(floor["jax_f64"]) == 1
    np.testing.assert_allclose(floor["port_f32"], floor["jax_f64"],
                               rtol=1e-1)
    assert floor["port_f32"] == ttable.initial_losses(loaded, 1, 16, 2,
                                                      device="cpu")


def test_bar_verdict():
    assert ttable.bar_verdict([1.0, 3.0, 2.0], [1.5, 2.5])["passed"]
    assert not ttable.bar_verdict([1.0, 1.2, 9.0], [1.5, 2.5])["passed"]
    assert ttable.bar_verdict([2.5], [1.5, 2.5]) == {
        "port_median": 2.5, "reference_min": 1.5, "reference_max": 2.5,
        "passed": True}


def test_sequential_row_evaluates_one_model_at_a_time(monkeypatch):
    """``sequential=True`` never takes the stacked loss; its first base
    loss is the fused row's, at the FD floor (the single and the stacked
    stencil are two f32 paths)."""
    kw = dict(hidden=16, tt_L=2, epochs=1, device="cpu")
    fused = ttable.run_row("tonn", True, True, **kw)

    def stacked(*a, **k):
        raise AssertionError("the sequential row took the stacked loss")

    monkeypatch.setattr(tpinn, "residual_losses_stacked", stacked)
    seq = ttable.run_row("tonn", True, True, sequential=True, **kw)
    assert seq["final_loss"] == pytest.approx(fused["final_loss"], rel=0.25)


def test_run_row_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttable.run_row("tt", False, False, **SMALL)
