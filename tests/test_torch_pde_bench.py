"""The port's PDE benchmarks on the CPU at toy widths:
``benchmarks/torch_pde_suite.py`` (the stacked-against-sequential parity
contract, ``run_problem``'s rows, ``--ci``'s budgets),
``benchmarks/torch_zo_step.py`` (``bench_mode``'s rows) and
``benchmarks/torch_residual_perf.py`` (its rows, off-path checks and
gates), each against the keys of the reference benchmark's committed JSON;
and ``benchmarks/torch_table1_hjb.run_row`` on a problem with a boundary
term.
"""

import json
import math
from pathlib import Path

import pytest

from benchmarks import torch_pde_suite as suite
from benchmarks import torch_residual_perf as rperf
from benchmarks import torch_table1_hjb as ttable
from benchmarks import torch_zo_step as zo

ROOT = Path(__file__).resolve().parents[1]


def _reference(name):
    return json.loads((ROOT / name).read_text())


@pytest.mark.parametrize("pde,mode", [("helmholtz-2d", "tt"),
                                      ("helmholtz-2d", "tonn"),
                                      ("hjb-10d", "tt")])
def test_parity_check_holds_the_contract(pde, mode):
    p = suite.parity_check(pde, hidden=16, batch=8, num_samples=3, tt_L=2,
                           mode=mode, device="cpu")
    assert set(p) == {"u_max_rel_err", "u_max_err_over_max_u",
                      "loss_max_rel_err", "losses_agree"}
    assert p["losses_agree"] is True
    assert p["u_max_err_over_max_u"] <= p["u_max_rel_err"] < suite.U_RTOL
    assert p["loss_max_rel_err"] < suite.LOSS_RTOL


def test_run_problem_row_has_the_reference_keys():
    ref = _reference("BENCH_pde_suite.json")["rows"][0]
    row = suite.run_problem("helmholtz-2d", hidden=16, batch=8, epochs=3,
                            num_samples=3, device="cpu")
    assert set(row) == set(ref)
    assert set(row["parity"]) == set(ref["parity"]) == {"tt", "tonn"}
    for mode in ("tt", "tonn"):      # the reference's, and the figure
        assert set(row["parity"][mode]) == \
            set(ref["parity"][mode]) | {"u_max_err_over_max_u"}
    assert row["has_boundary_loss"] is True and row["in_dim"] == 2
    assert math.isfinite(row["final_loss"]) and math.isfinite(row["val_mse"])
    assert suite.failures({"rows": [row]}) == []


def test_ci_applies_the_reference_budgets_except_explicit_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr(suite, "run_problem", lambda pde, **kw: seen.update(
        {pde: kw}) or {"pde": pde})
    out = suite.run(["black-scholes-100d", "hjb-10d"], hidden=16, batch=4,
                    epochs=5, ci=True, explicit=frozenset({"epochs"}),
                    device="cpu")
    assert seen["black-scholes-100d"]["batch"] == 8     # CI_SIZES
    assert seen["black-scholes-100d"]["epochs"] == 5    # set by hand
    assert seen["hjb-10d"]["batch"] == 4
    assert out["config"]["budgets"]["black-scholes-100d"] == {
        "hidden": 16, "batch": 8, "epochs": 5}
    assert out["config"]["device"]["type"] == "cpu"


def test_failures_name_a_divergence_and_a_nonfinite_loss():
    row = {"pde": "x", "final_loss": float("nan"),
           "parity": {"tt": {"losses_agree": False}}}
    bad = suite.failures({"rows": [row]})
    assert len(bad) == 2 and "[tt]" in bad[0] and "non-finite" in bad[1]


@pytest.mark.parametrize("main", [suite.main, zo.main, rperf.main])
def test_out_is_required(main, capsys):
    with pytest.raises(SystemExit):
        main(["--device", "cpu"])
    assert "--out" in capsys.readouterr().err


def test_zo_step_row_has_the_reference_keys(tmp_path):
    ref = _reference("BENCH_zo_step.json")["rows"][0]
    out = tmp_path / "zo.json"
    for _ in range(2):                  # appends one record a call
        zo.main(["--hidden", "16", "--batch", "8", "--num-samples", "3",
                 "--tt-L", "2", "--repeats", "1", "--iters", "1", "--modes",
                 "tt", "--pde", "helmholtz-2d", "--device", "cpu", "--out",
                 str(out)])
    doc = json.loads(out.read_text())
    assert len(doc["runs"]) == 2
    row = doc["runs"][0]["rows"][0]
    assert set(row) == set(ref) | {"pde", "launches_per_step",
                                   "u_max_err_over_max_u"}
    assert row["pde"] == "helmholtz-2d" and row["losses_agree"] is True
    assert row["naive_seed_ms"] > 0 and row["fused_ms"] > 0
    assert row["launches_per_step"] == {"naive_seed": None, "fused": None}
    assert doc["runs"][0]["config"]["device"]["type"] == "cpu"


@pytest.mark.parametrize("on_chip", [True, False])
def test_table1_row_passes_the_boundary_batch_to_its_arm(monkeypatch,
                                                         on_chip):
    """On helmholtz-2d each epoch's loss gets the trainer's
    ``max(batch // 4, 8)`` boundary rows, in the ZO and the off-chip arm;
    hjb-20d's get none."""
    seen = []
    for name in ("residual_loss", "residual_losses_stacked"):
        real = getattr(ttable.pinn, name)

        def spy(*a, _real=real, **kw):
            seen.append(kw.get("term_batches"))
            return _real(*a, **kw)
        monkeypatch.setattr(ttable.pinn, name, spy)
    r = ttable.run_row("tt", on_chip, False, hidden=16, tt_L=2, epochs=2,
                       batch=8, pde="helmholtz-2d", device="cpu")
    assert math.isfinite(r["final_loss"]) and math.isfinite(r["val_mse_ideal"])
    assert seen and all(tuple(tb["boundary"][0].shape) == (8, 2)
                        for tb in seen)
    seen.clear()
    ttable.run_row("tt", on_chip, False, hidden=16, tt_L=2, epochs=1,
                   batch=8, pde="hjb-10d", device="cpu")
    assert seen and all(not tb for tb in seen)


def test_residual_perf_row_has_the_reference_keys_and_gates(tmp_path):
    """The spectral-against-FD benchmark at toy width: the reference's row
    keys (with each arm's launches a step), its 3.28× bill, the off-path
    checks all bit-identical, and every gate reported with its
    reference bound."""
    ref = _reference("BENCH_residual_perf.json")
    out = tmp_path / "rp.json"
    rperf.main(["--hidden", "16", "--tt-L", "2", "--epochs", "2",
                "--repeats", "1", "--iters", "1", "--pdes", "hjb-10d",
                "--device", "cpu", "--out", str(out)])
    run = json.loads(out.read_text())["runs"][0]
    row = run["rows"][0]
    assert set(row) == set(ref["rows"][0]) | {"fd_launches_per_step",
                                              "spectral_launches_per_step"}
    assert (row["fd_inferences_per_loss"],
            row["spectral_inferences_per_loss"]) == (2300, 702)
    assert run["off_path"] == ref["off_path"]
    assert all(run["off_path"].values())
    assert set(run["gates"]) == {f"hjb-10d/{g}" for g in (
        "inference_ratio", "mse_ratio", "step_speedup")} | {"off_path"}
    assert run["gates"]["hjb-10d/mse_ratio"]["bound"] == \
        ref["config"]["mse_ratio_gate"]
    assert run["gates"]["hjb-10d/inference_ratio"]["passed"] is True
    assert run["config"]["arms"] == ref["config"]["arms"]
    assert run["config"]["device"]["type"] == "cpu"
