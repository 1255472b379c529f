#!/usr/bin/env python3
"""The tonn (or onn) BP step (hjb-20d, batch 100, noise on, AdamW) of the
port in the checkout at ROOT, on one GPU.

    python3 tools/tonn_bp_step.py ROOT [--pinn-mode onn] [--hidden H]

Trains 60 steps through ``launch.train.main`` at hidden 1024 (or H; the
mode's default layout otherwise: tonn's PAPER_TONN_SPEC cores, onn's
meshes of H ports) and takes the host's median step over steps 5 on
(``host_step_ms_median``), then times the step with ROOT's
``chip_smoke.measure_bp_step`` (CUDA events over 200 steps back to back,
``bp_step_ms``, and a traced window of 5 steps: busy share, kernels a
step, the mesh kernels' device time: the grouped ones in tonn,
``mesh_densify_ms``, every mesh kernel in onn, ``mesh_kernels_ms``).
Run it for the parent (a ``git archive`` under ``build/``) and this
checkout in turns, each a process: parent, change, change, parent.
Prints one ``[bp-step]`` JSON line.
"""

from __future__ import annotations

import json
import sys

ARGV = ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--batch", "100",
        "--log-every", "1000", "--seed", "0", "--pinn-noise", "--optimizer",
        "adamw", "--steps", "60"]


def option(name: str, default: str) -> str:
    return (sys.argv[sys.argv.index(name) + 1] if name in sys.argv
            else default)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tonn_bp_step: no CUDA device", file=sys.stderr)
        return 2
    root = sys.argv[1]
    sys.path[:0] = [root, root + "/src"]
    import numpy as np

    import chip_smoke
    from repro_torch.data import pde_collocation_iterator
    from repro_torch.launch import train
    from repro_torch.optim import get_optimizer
    mode, hidden = option("--pinn-mode", "tonn"), option("--hidden", "1024")
    res = train.main(ARGV + ["--pinn-mode", mode, "--hidden", hidden])
    xt = next(pde_collocation_iterator(100, seed=0, start_step=60,
                                       problem=res.model.problem))
    t = chip_smoke.measure_bp_step(res.model, get_optimizer("adamw"),
                                   res.params, res.hw_noise,
                                   xt.to(torch.device("cuda")), iters=200,
                                   match="mesh_densify" if mode == "tonn"
                                   else "mesh_")
    tr = t["trace"]
    print("[bp-step]", json.dumps({
        "root": root, "pinn_mode": mode, "hidden": int(hidden),
        "bp_step_ms": t["bp_step_ms"],
        "host_step_ms_median": 1e3 * float(np.median(res.step_seconds[5:])),
        "trace_busy": tr["busy_share"],
        "trace_kernels_per_call": tr["kernels_per_call"],
        "trace_wall_ms": tr["wall_ms"], "trace_device_ms": tr["device_ms"],
        "mesh_densify_ms" if mode == "tonn" else "mesh_kernels_ms":
        tr.get("match_ms"), "val_mse": res.val_mse,
        "loss_last": res.losses[-1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
