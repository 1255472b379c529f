#!/usr/bin/env python3
"""ms per ZO step of one version of the PyTorch/CUDA port on one GPU.

    python3 tools/zo_step.py [SRC]

Measures the ``repro_torch`` package under SRC (default: this checkout's
``src``) with this checkout's ``chip_smoke.measure_zo_step``, so that two
versions of the port are measured by the same code: TONN_ONCHIP_FUSED
(hjb-20d, tonn, hidden 1024, noise on), N = 10, batch 100, f32 and then
int8 block 32 with 8-bit phases.  For each, three runs of 10 steps on CUDA
events, a traced window of steps, and the aten ops of one
``prepare_params_stacked``.  To compare a parent with a change, unpack
each with ``git archive`` and run this on parent, change, change, parent
in one session on one card.  Prints one ``[zo-step]`` JSON line and the
card's name and power limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(device, chip_smoke) -> dict:
    from repro_torch.configs.hjb_pinn import pinn_config
    from repro_torch.core import pinn, zoo
    from repro_torch.device import counter_generator, to_device
    from repro_torch.kernels.quant import QuantConfig

    out = {}
    for tag, quant in (("f32", QuantConfig()),
                       ("qat-int8-pb8", QuantConfig(
                           enabled=True, dtype="int8", block=32,
                           phase_bits=8))):
        model = pinn.TensorPinn(pinn_config("hjb-20d", "tonn", True, True,
                                            quant=quant))
        params = to_device(model.init(counter_generator(0)), device)
        noise = to_device(model.sample_noise(counter_generator(0, 99)),
                          device)
        mask = model.trainable_mask(params)
        xt = model.problem.sample_collocation(counter_generator(1),
                                              100).to(device)
        xis = zoo.sample_perturbations(counter_generator(2, device=device),
                                       params, 10, mask)
        stacked = zoo.perturbed_stack(params, xis,
                                      zoo.SPSAConfig(num_samples=10))
        out[tag] = {
            **chip_smoke.measure_zo_step(model, params, noise, mask, xt,
                                         zoo.ZOState(seed=1), 10, runs=3),
            "prepare_params_stacked": chip_smoke.op_counts(
                chip_smoke.aten_ops(
                    lambda: model.prepare_params_stacked(stacked, noise)))}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("zo_step: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"zo_step: {src} holds no checkout of the port "
              "(no repro_torch)", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import chip_smoke
    import repro_torch
    _, _, card = chip_smoke.phase_device()
    out = measure(repro_torch.resolve_device("cuda"), chip_smoke)
    print(f"[zo-step] {json.dumps({'src': str(src), **out})}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
