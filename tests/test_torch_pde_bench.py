"""The port's PDE benchmarks on the CPU at toy widths:
``benchmarks/torch_pde_suite.py`` (the stacked-against-sequential parity
contract, ``run_problem``'s rows, ``--ci``'s budgets),
``benchmarks/torch_zo_step.py`` (``bench_mode``'s rows) and
``benchmarks/torch_residual_perf.py`` (its rows, off-path checks and
gates), ``benchmarks/torch_ns_data.py`` and
``benchmarks/torch_coeff_family.py`` (their records and gates),
``benchmarks/torch_distributed_zo.py --ci`` (8 CPU ranks), each against
the keys of the reference benchmark's committed JSON; and
``benchmarks/torch_table1_hjb.run_row`` on a problem with a boundary term.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from benchmarks import torch_coeff_family as cfam
from benchmarks import torch_distributed_zo as dzo
from benchmarks import torch_ns_data as nsdata
from benchmarks import torch_pde_suite as suite
from benchmarks import torch_residual_perf as rperf
from benchmarks import torch_table1_hjb as ttable
from benchmarks import torch_zo_step as zo
from test_torch_pinn import share_cores  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("main", [suite.main, zo.main, rperf.main,
                                  nsdata.main, cfam.main, dzo.main])
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


def test_ns_data_record_has_the_reference_keys_and_gates(tmp_path):
    """The ns-2d benchmark at toy width and budget: the reference's arms,
    spectral-path and legacy-parity keys (every registered problem), the
    spectral path bit for bit, every problem's parity, the four gates
    with the reference's bounds, and the reference's own numbers beside."""
    ref = _reference("BENCH_ns_data.json")
    out = tmp_path / "ns.json"
    nsdata.main(["--hidden", "8", "--epochs", "2", "--batch", "4",
                 "--num-samples", "2", "--device", "cpu", "--out", str(out)])
    run = json.loads(out.read_text())["runs"][0]
    assert set(run["arms"]) == set(ref["arms"])
    for arm in run["arms"].values():
        assert set(ref["arms"]["full"]) <= set(arm)
        assert arm["resolved_deriv"] == "spectral"
    assert set(run["spectral_path"]) == set(ref["spectral_path"])
    assert run["spectral_path"]["loss_bit_identical_to_line_assembly"]
    assert run["spectral_path"]["inferences_per_loss"] == \
        ref["spectral_path"]["inferences_per_loss"]
    assert set(run["legacy_parity"]) == set(ref["legacy_parity"])
    assert all(run["legacy_parity"].values())
    assert set(run["gates"]) == {"val_mse_floor", "data_ablation",
                                 "periodic_spectral_path",
                                 "legacy_loss_parity"}
    assert run["gates"]["val_mse_floor"]["bound"] == \
        ref["config"]["val_mse_gate"]
    assert run["gates"]["data_ablation"]["bound"] == \
        ref["config"]["ablation_gate"]
    assert run["gates"]["periodic_spectral_path"]["passed"]
    assert run["reference"]["val_mse"] == {
        k: v["val_mse"] for k, v in ref["arms"].items()}


def test_coeff_family_record_has_the_reference_keys_and_gates():
    """The coefficient-family benchmark at toy width and budget on one
    family: the reference's family and row keys, the off-path checks all
    bit-identical, one ``c1`` program serving within an ulp, and every gate
    reported; its ``--zo`` arm at batch 8."""
    ref = _reference("BENCH_coeff_family.json")
    run = json.loads(json.dumps(cfam.run(families=("hjb",), hidden=8,
                                         steps=2, device="cpu")))
    fam, want = run["families"]["hjb"], ref["families"]["hjb"]
    assert set(want) <= set(fam) and fam["coeff_spec"] == want["coeff_spec"]
    assert [r["coeffs"] for r in fam["held_out"]] == \
        [r["coeffs"] for r in want["held_out"]]
    assert set(fam["held_out"][0]) == set(want["held_out"][0])
    assert run["f32_off_path"] == ref["f32_off_path"]
    assert all(run["f32_off_path"].values())
    assert run["gates"]["serving"]["passed"]
    assert len(run["gates"]) == 3 + 2 + 2
    zo_run = cfam.run_zo(torch.device("cpu"), steps=2, batch=8, hidden=16)
    assert zo_run["pde"] == "black-scholes-100d-rs" and zo_run["hidden"] == 16
    assert len(zo_run["held_out"]) == 3 and zo_run["coeffs_per_step"] == 4
    assert all(math.isfinite(r["val_mse"]) for r in zo_run["held_out"])


def test_distributed_zo_ci_record_has_the_reference_keys(tmp_path):
    """``--ci``: 8 CPU ranks, the reference's layouts and row keys, every
    layout's wire within its O(N) bound and below the params' bytes, and
    the gradient identity on every registered PDE (the reference's own
    ``BENCH_distributed_zo.json`` covers the six it had)."""
    ref = _reference("BENCH_distributed_zo.json")
    out = tmp_path / "dz.json"
    res = dzo.main(["--ci", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["config"]["world"] == 8 and res["config"]["device"] == "cpu"
    assert [r["layout"] for r in res["layouts"]] == [
        r["layout"] for r in ref["layouts"]]
    for r in res["layouts"]:
        assert set(ref["layouts"][0]) <= set(r)
        assert r["wire_bytes_per_step"] <= r["wire_bound_bytes"] \
            < r["param_bytes"]
        assert (r["wire_bytes_per_step"] > 0) == (r["devices"] > 1)
        assert len(r["step_ms_ranks"]) == r["devices"]
    from repro_torch import pde as tpde
    assert [r["pde"] for r in res["identity"]] == list(tpde.available())
    assert {r["pde"] for r in ref["identity"]} <= set(tpde.available())
    for r in res["identity"]:
        assert set(ref["identity"][0]) <= set(r) and r["identity"], r
