#!/usr/bin/env python3
"""The north star's bar through the trainer CLI: hjb-20d, five seeds.

    python3 tools/cli_bar.py --out FILE [--seeds 0,1,2,3,4] [--steps 1000]
    python3 tools/cli_bar.py --port-json FILE --jax-logs DIR --out FILE

The first form runs ``python -m repro_torch.launch.train --arch tensor-pinn
--pde hjb-20d --pinn-noise --batch 100 --steps 1000 --seed S`` for each
seed, in this process, on the card (the trainer's default device), and
writes each seed's final val MSE, losses and wall time, the card's name and
power limit to FILE as one JSON object.

The second form reads those results and the JAX package's final val MSEs
from DIR/seed<S>.log, the output of

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.train \\
        --arch tensor-pinn --pde hjb-20d --pinn-noise --batch 100 \\
        --steps 1000 --seed S --log-every 100 > DIR/seedS.log

(its "[pinn] final val MSE" line), and writes to FILE, and prints, the
verdict by the rule of ``benchmarks/torch_table1_hjb.py --bar``
(``bar_verdict``): the port's median must lie within the min–max of the
JAX package's runs.  Each JAX seed's command and final line go beside it;
with no finished JAX log the verdict is None.  The two packages draw their
own chips, batches and perturbations, so the seeds pair nothing.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
FINAL = re.compile(r"\[pinn\] final val MSE ([0-9.eE+-]+)")


def run_port(seeds: list, steps: int) -> dict:
    import torch
    from repro_torch.launch import train

    runs = {}
    for seed in seeds:
        t0 = time.perf_counter()
        res = train.main(["--arch", "tensor-pinn", "--pde", "hjb-20d",
                          "--pinn-noise", "--batch", "100", "--steps",
                          str(steps), "--seed", str(seed), "--log-every",
                          "100"])
        torch.cuda.synchronize()
        runs[str(seed)] = {"val_mse": res.val_mse,
                           "loss_first": res.losses[0],
                           "loss_last": res.losses[-1],
                           "wall_s": time.perf_counter() - t0,
                           "host_step_ms_median": 1e3 * statistics.median(
                               res.step_seconds)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return {"steps": steps, "runs": runs, "card": card}


JAX_ARGV = ("PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.train "
            "--arch tensor-pinn --pde hjb-20d --pinn-noise --batch 100 "
            "--steps {steps} --seed {seed} --log-every 100")


def verdict(port: dict, jax_logs: Path) -> dict:
    from benchmarks.torch_table1_hjb import bar_verdict

    jax = {}
    for log in sorted(jax_logs.glob("seed*.log")):
        found = [ln for ln in log.read_text().splitlines()
                 if FINAL.search(ln)]
        if found:
            seed = log.stem[4:]
            jax[seed] = {"val_mse": float(FINAL.search(found[-1]).group(1)),
                         "final_line": found[-1].strip(),
                         "command": JAX_ARGV.format(steps=port["steps"],
                                                    seed=seed)}
    port_vals = {s: r["val_mse"] for s, r in port["runs"].items()}
    out = {"port": port_vals, "port_card": port["card"], "jax_cpu": jax,
           "jax_seeds_finished": len(jax), "steps": port["steps"]}
    if not jax:
        return {**out, "passed": None}
    return {**out, **bar_verdict(list(port_vals.values()),
                                 [r["val_mse"] for r in jax.values()])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--port-json")
    ap.add_argument("--jax-logs")
    args = ap.parse_args()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    if args.port_json:
        out = verdict(json.loads(Path(args.port_json).read_text()),
                      Path(args.jax_logs))
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
        print(json.dumps(out))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("cli_bar: no CUDA device", file=sys.stderr)
        return 2
    res = run_port([int(s) for s in args.seeds.split(",")], args.steps)
    Path(args.out).write_text(json.dumps(res))
    print(f"[cli-bar] {json.dumps(res)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
