#!/usr/bin/env python3
"""The onn baseline's step, training and serving on one GPU, for one version
of the PyTorch/CUDA port.

    python3 tools/onn_step.py [SRC]

Measures the ``repro_torch`` package under SRC (default: this checkout's
``src``) with this checkout's ``chip_smoke`` helpers, so that two versions
of the port are measured by the same code: ``ONN_ONCHIP`` (hjb-20d, onn,
hidden 1024, noise on) on the fused path (``fd_fast``), N = 10, batch 100,
as ``--pinn-mode onn --pinn-noise`` trains it.

  * ``zo_step_ms``: three runs of 5 fused ZO steps on CUDA events
    (``chip_smoke.measure_zo_step``), and a traced window of 5 steps whose
    ``match_each_ms`` lists each mesh kernel's device time in launch order.
  * ``train``: ``launch.train.main`` for 10 steps from seed 0, its losses,
    val MSE and the mesh launches per design.
  * ``program_ms``: a served program, ``model.u`` on a 2048-point pool.

To compare a parent with a change, unpack each with ``git archive`` and run
this on parent, change, change, parent in one session on one card.  Prints
one ``[onn-step]`` JSON line and the card's name and power limit.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(device, chip_smoke) -> dict:
    import torch
    from repro_torch.configs.hjb_pinn import pinn_config
    from repro_torch.core import pinn, zoo
    from repro_torch.device import counter_generator, to_device
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.launch import train

    model = pinn.TensorPinn(pinn_config("hjb-20d", "onn", True, True))
    params = to_device(model.init(counter_generator(0)), device)
    noise = to_device(model.sample_noise(counter_generator(0, 99)), device)
    mask = model.trainable_mask(params)
    xt = model.problem.sample_collocation(counter_generator(1),
                                          100).to(device)
    out = chip_smoke.measure_zo_step(model, params, noise, mask, xt,
                                     zoo.ZOState(seed=1), 10, runs=3,
                                     iters=5, match="mesh_")
    designs = mesh.mesh_apply_stacked.design_launches
    for key in designs:
        designs[key] = 0
    res = train.main(["--arch", "tensor-pinn", "--pde", "hjb-20d",
                      "--pinn-mode", "onn", "--pinn-noise", "--batch", "100",
                      "--zo-samples", "10", "--seed", "0", "--steps", "10",
                      "--log-every", "5"])
    out["train"] = {"losses": [float(v) for v in res.losses],
                    "val_mse": res.val_mse, "launches": dict(designs)}
    pool = model.problem.sample_collocation(counter_generator(2),
                                            2048).to(device)
    with torch.no_grad():
        out["program_ms"] = chip_smoke._time_ms(
            lambda: model.u(params, pool, noise), 5, warmup=1)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("onn_step: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"onn_step: {src} holds no checkout of the port "
              "(no repro_torch)", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import chip_smoke
    import repro_torch
    _, _, card = chip_smoke.phase_device()
    out = measure(repro_torch.resolve_device("cuda"), chip_smoke)
    print(f"[onn-step] {json.dumps({'src': str(src), **out})}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
