"""``tools/cli_bar.py``'s verdict form: the 7a rule over the port's CLI runs
and the JAX package's logs, with each JAX seed's command and final line."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SPEC = importlib.util.spec_from_file_location("cli_bar",
                                              ROOT / "tools" / "cli_bar.py")
cli_bar = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(cli_bar)

PORT = {"steps": 1000, "card": "NVIDIA H100 80GB HBM3, 700.00 W",
        "runs": {str(s): {"val_mse": v} for s, v in
                 enumerate([3e-6, 1e-6, 2e-6, 5e-6, 4e-6])}}


@pytest.mark.parametrize("jax_vals, passed", [
    ({}, None),                              # no JAX seed finished
    ({0: "2.0e-06", 1: "5.0e-06"}, True),    # median 3e-6 inside
    ({0: "1.0e-07", 3: "2.5e-06"}, False),   # median 3e-6 above
])
def test_verdict_by_the_7a_rule(tmp_path, monkeypatch, jax_vals, passed):
    for seed, val in jax_vals.items():
        (tmp_path / f"seed{seed}.log").write_text(
            f"step 900 loss 1e-2\n[pinn] final val MSE {val}\n")
    (tmp_path / "seed9.log").write_text("step 0 loss 1.0\n")   # unfinished
    port = tmp_path / "port.json"
    port.write_text(json.dumps(PORT))
    out = tmp_path / "verdict.json"
    monkeypatch.setattr("sys.argv", ["cli_bar.py", "--port-json", str(port),
                                     "--jax-logs", str(tmp_path),
                                     "--out", str(out)])
    assert cli_bar.main() == 0
    got = json.loads(out.read_text())
    assert got["passed"] is passed
    assert got["jax_seeds_finished"] == len(jax_vals)
    assert got["port_card"] == PORT["card"]
    for seed, val in jax_vals.items():
        row = got["jax_cpu"][str(seed)]
        assert row["val_mse"] == float(val)
        assert row["final_line"] == f"[pinn] final val MSE {val}"
        assert row["command"].endswith(f"--seed {seed} --log-every 100")
    if jax_vals:
        assert got["port_median"] == 3e-6
        assert got["reference_min"] == min(map(float, jax_vals.values()))


def test_out_is_required(monkeypatch):
    monkeypatch.setattr("sys.argv", ["cli_bar.py", "--port-json", "x",
                                     "--jax-logs", "y"])
    with pytest.raises(SystemExit):
        cli_bar.main()
