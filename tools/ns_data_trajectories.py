#!/usr/bin/env python3
"""ns-2d's two ZO arms (``benchmarks/torch_ns_data.py``) on the card and on
the CPU from the same seed, their losses epoch by epoch side by side.

    python3 tools/ns_data_trajectories.py --out FILE [--seeds 0,1,2,3,4]

For each seed and arm it runs ``torch_ns_data.train_arm`` at the
benchmark's config three times: on the card as the benchmark does
(``cuda``: ξ drawn by the card's generator), on the card with each step's
ξ drawn as the CPU draws it (``cuda_cpu_xi``: the CPU's run up to
floating point), and on the CPU (``cpu``).  It writes to FILE, for each:
the val MSE and the ablation ratio of each run; against the CPU's, each
card run's relative loss gap |card − CPU| / |CPU| at epoch 0 and the
first epoch at which it exceeds 1e-3 and 1e-1 (None where it never
does); and every loss trajectory.  Then, at each arm's final card
parameters and on one batch of all three terms, ``per_term_losses`` on
the card against the CPU: the data term's value on both devices at the
same inputs.  The card's name and power limit go beside.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from benchmarks import torch_ns_data as nsd  # noqa: E402
from benchmarks.torch_table1_hjb import card_line  # noqa: E402
from repro_torch.core import pinn  # noqa: E402
from repro_torch.data import pde_term_batch_iterator  # noqa: E402
from repro_torch.device import counter_generator, to_device  # noqa: E402

CONFIG = {"hidden": 32, "epochs": 600, "batch": 16, "num_samples": 10,
          "lr": 3e-2, "mu": 0.02}       # the benchmark's defaults
GAPS = (1e-3, 1e-1)
CARD = "cuda"
RUNS = ("cuda", "cuda_cpu_xi", "cpu")


def first_gap(card: list, cpu: list, gap: float) -> int | None:
    for (i, a), (_, b) in zip(card, cpu):
        if abs(a - b) > gap * abs(b):
            return i
    return None


def term_check(model, params_card: dict, seed: int) -> dict:
    """``per_term_losses`` at the same parameters and batch on both
    devices: max relative gap over the three terms."""
    problem = model.problem
    xt = problem.sample_collocation(counter_generator(seed, 10_000, 0), 64)
    tb = next(pde_term_batch_iterator(64, seed=seed + 77, problem=problem))
    cuda, cpu = torch.device(CARD), torch.device("cpu")
    with torch.no_grad():
        on = {k: float(v) for k, v in pinn.per_term_losses(
            model, params_card, xt.to(cuda),
            term_batches=to_device(tb, cuda)).items()}
        off = {k: float(v) for k, v in pinn.per_term_losses(
            model, to_device(params_card, cpu), xt,
            term_batches=tb).items()}
    return {"card": on, "cpu": off,
            "max_rel_gap": max(abs(on[k] - off[k]) / abs(off[k])
                               for k in off)}


def run(seeds) -> dict:
    out = {"config": CONFIG, "nvidia_smi": card_line(),
           "torch": torch.__version__, "seeds": {}}
    for seed in seeds:
        row = {}
        for arm, ablate in (("full", False), ("no_data", True)):
            cpu = torch.device("cpu")
            runs = {name: nsd.train_arm(
                        ablate, seed=seed, log_every=1,
                        dev=cpu if name == "cpu" else torch.device(CARD),
                        xi_device=cpu if name == "cuda_cpu_xi" else None,
                        **CONFIG)
                    for name in RUNS}
            ref = runs["cpu"]["losses"]
            row[arm] = {
                "val_mse": {k: r["val_mse"] for k, r in runs.items()},
                "epoch0_rel_gap": {
                    k: abs(runs[k]["losses"][0][1] - ref[0][1])
                    / abs(ref[0][1]) for k in RUNS[:2]},
                "first_epoch_gap_over": {
                    k: {f"{g:g}": first_gap(runs[k]["losses"], ref, g)
                        for g in GAPS} for k in RUNS[:2]},
                "terms_at_card_params": term_check(
                    runs["cuda"]["_model"], runs["cuda"]["_params"], seed),
                "losses": {k: r["losses"] for k, r in runs.items()}}
        row["ablation_ratio"] = {
            k: row["no_data"]["val_mse"][k] / row["full"]["val_mse"][k]
            for k in RUNS}
        out["seeds"][str(seed)] = row
        brief = {arm: {k: v for k, v in row[arm].items() if k != "losses"}
                 for arm in ("full", "no_data")}
        print(json.dumps({"seed": seed, "ablation_ratio":
                          row["ablation_ratio"], **brief}), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seeds", default="0,1,2,3,4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: it compares the card with "
                         "the CPU")
    result = run([int(s) for s in args.seeds.split(",")])
    print(f"[ns-2d trajectories] {result['nvidia_smi']}", flush=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
