#!/usr/bin/env python3
"""The sequential ZO step and serving's load of one version of the port.

    python3 tools/seq_step.py [SRC]

Runs the ``repro_torch`` package under SRC (default: this checkout's
``src``) with this checkout's ``chip_smoke`` timers, so that two versions
of the port are measured by the same code, on TONN_ONCHIP (hjb-20d, tonn,
hidden 1024, noise on), N = 10, batch 100:

  * the trainer with ``--sequential`` for 3 steps: the losses, and a
    SHA-256 of the final params' bytes;
  * a sequential step on CUDA events and one traced step (kernels, device
    time, the busy share, the top 5 kernels);
  * a fresh solver registered for serving (seed 0): its u on 700 fixed
    points, as a SHA-256 of the bytes and the first values, and the time
    of the registration, whose densification is the load.

Two versions agree bit for bit where their hashes do.  To compare a parent
with a change, unpack each with ``git archive`` and run this on parent,
change, change, parent in one run on one card.  Prints one
``[seq-step]`` JSON line and the card's name and power limit.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(device, chip_smoke) -> dict:
    import torch
    from repro_torch.configs.hjb_pinn import pinn_config
    from repro_torch.core import pinn, zoo
    from repro_torch.launch import train
    from repro_torch.serving import SolverRegistry

    steps = 3
    res = train.main(["--arch", "tensor-pinn", "--pde", "hjb-20d",
                      "--pinn-mode", "tonn", "--pinn-noise", "--sequential",
                      "--steps", str(steps), "--batch", "100",
                      "--zo-samples", "10", "--log-every", "10",
                      "--seed", "0"])
    model, params, noise = res.model, res.params, res.hw_noise
    mask = model.trainable_mask(params)
    xt = model.problem.sample_collocation(
        torch.Generator().manual_seed(1), 100).to(device)
    scfg = zoo.SPSAConfig(num_samples=10)

    def seq_step():
        return zoo.zo_signsgd_step(
            params, zoo.ZOState(steps, 1), 1e-3, scfg, trainable_mask=mask,
            loss_fn=lambda q: pinn.residual_loss(model, q, xt, noise))

    reg = SolverRegistry(device=device)
    cfg = pinn_config("hjb-20d", "tonn", True, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = reg.register_fresh("hjb", cfg, seed=0, device=device)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    pts = solver.model.problem.sample_collocation(
        torch.Generator().manual_seed(11), 700).to(device)
    with torch.no_grad():
        u = solver.model.u(solver.params, pts)
    return {"losses": [float(v) for v in res.losses],
            "params_sha256": _digest(zoo.tree_leaves(params)),
            "val_mse": res.val_mse,
            "seq_step_ms": chip_smoke._time_ms(seq_step, 3, warmup=1),
            "seq_step_trace": chip_smoke._profile(seq_step, 1),
            "load_ms": load_ms,
            "served_u_sha256": _digest([u]),
            "served_u_head": u[:4].tolist()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("seq_step: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"seq_step: {src} holds no checkout of the port "
              "(no repro_torch)", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import chip_smoke
    import repro_torch
    _, _, card = chip_smoke.phase_device()
    out = measure(repro_torch.resolve_device("cuda"), chip_smoke)
    print(f"[seq-step] {json.dumps({'src': str(src), **out})}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
