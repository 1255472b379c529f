#!/usr/bin/env python3
"""``tt_contract_grad`` (the TT chain's backward, the BP baselines' kernel)
on one GPU, for one version of the PyTorch/CUDA port.

    python3 tools/tt_grad.py [SRC] [--sweep]

Measures the ``repro_torch`` package under SRC (default: this checkout's
``src``) with this checkout's ``chip_smoke`` helpers, so that two versions
are measured by the same code:

  * ``ptxas``: registers, shared memory and spills of every kernel of
    ``csrc/tt_contract.cu``, from its build log.
  * ``calls``: the three launches of a BP step at the paper's spec (batch
    100: layer 0 on the 100 rows and on the 21 identity columns without
    dx, the hidden layer on 4300 rows with dx) and a wide spec
    (``auto_factorize(4096, 4096, L=4, max_rank=2)``, 777 rows with dx):
    ms per call on CUDA events over back-to-back calls, and a traced
    window of 5 calls (after one PyTorch fill) with the kernels a call and
    each kernel's device time alone.
  * ``bp``: ``launch.train.main`` with tt and AdamW for 50 steps from seed
    0 (its losses, val MSE and ``tt_contract_grad`` launches), and a BP
    step's ms on CUDA events with its kernels a step
    (``chip_smoke.measure_bp_step``).
  * ``--sweep`` (this checkout's kernel only): the hidden and layer-0
    launches through the C entry at every count of saved states and a
    range of rows a block, each checked (dx bit for bit against the
    wrapper's, every dG_k within ``grad_bound``'s formula at that tiling)
    and timed on CUDA events and alone in a trace.

To compare a parent with a change, unpack each with ``git archive`` and run
this on parent, change, change, parent in one command on one card.  Prints
``[tt-grad]`` JSON lines and the card's name and power limit.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SWEEP_ROWS = (1, 2, 3, 4, 5, 6, 8, 11, 16)


def _cases():
    from repro_torch.core import tt
    paper = tt.PAPER_TONN_SPEC
    return {"layer0-rows": (paper, 100, False),
            "layer0-columns": (paper, 21, False),
            "hidden-stencil": (paper, 4300, True),
            "wide-777": (tt.auto_factorize(4096, 4096, L=4, max_rank=2), 777,
                         True)}


def _inputs(spec, B: int, seed: int, device):
    import torch
    from repro_torch.core import tt
    gen = torch.Generator().manual_seed(seed)
    cores = [c.to(device) for c in tt.tt_init(gen, spec)]
    x = torch.randn((B, spec.in_dim), generator=gen).to(device)
    dy = torch.randn((B, spec.out_dim), generator=gen).to(device)
    return cores, x, dy


def _alone(chip_smoke, fn, device) -> dict:
    """A traced window of 5 calls after one PyTorch fill: the kernels the
    trace recorded a call (the profiler may drop some) and each kernel's
    device time per recorded launch."""
    import torch
    trace = chip_smoke._profile(fn, 5, match="tt_contract_grad",
                                lead=lambda: torch.zeros(1, device=device))
    each = {name: ms / n for name, ms, n in trace["top"]
            if "tt_contract_grad" in name}
    return {"kernels_per_call": trace["match_kernels"] / 5,
            "each_ms": each,
            "alone_ms": sum(each.values()) if each else None}


def measure(device, chip_smoke) -> dict:
    import dataclasses
    import numpy as np
    from repro_torch.kernels import tt_contract as ttc
    from repro_torch.launch import train

    out = {"calls": {}}
    for i, (label, (spec, B, need_dx)) in enumerate(_cases().items()):
        cores, x, dy = _inputs(spec, B, 4000 + i, device)

        def call():
            return ttc.tt_contract_grad(x, cores, spec, dy, need_dx)

        row = {"rows": B, "need_dx": need_dx,
               "tile": dataclasses.asdict(ttc.grad_tile(spec, B)),
               "ms": chip_smoke._time_ms(call, 50 if B > 1000 else 200),
               **_alone(chip_smoke, call, device)}
        out["calls"][label] = row
        print(f"[tt-grad] {label} {json.dumps(row)}", flush=True)
    ttc.tt_contract_grad.launches = 0
    res = train.main(["--arch", "tensor-pinn", "--pde", "hjb-20d",
                      "--pinn-mode", "tt", "--optimizer", "adamw",
                      "--batch", "100", "--seed", "0", "--steps", "50",
                      "--log-every", "25"])
    launches = ttc.tt_contract_grad.launches
    model, params, noise = res.model, res.params, res.hw_noise
    from repro_torch.data import pde_collocation_iterator
    from repro_torch.optim import get_optimizer
    xt = next(pde_collocation_iterator(100, seed=0, start_step=50,
                                       problem=model.problem)).to(device)
    timed = chip_smoke.measure_bp_step(model, get_optimizer("adamw"), params,
                                       noise, xt)
    out["bp"] = {"losses": [float(v) for v in res.losses],
                 "val_mse": res.val_mse,
                 "host_step_ms_median": 1e3 * float(np.median(
                     res.step_seconds)),
                 "tt_contract_grad_launches": launches,
                 "bp_step_ms": timed["bp_step_ms"],
                 "bp_step_kernels": timed["trace"]["kernels_per_call"],
                 "bp_step_device_ms": timed["trace"]["device_ms"],
                 "bp_step_busy_share": timed["trace"]["busy_share"]}
    print(f"[tt-grad] bp {json.dumps(out['bp'])}", flush=True)
    return out


def _launch_at(x, cores, spec, dy, need_dx, rows: int, saved: int,
               blocks: int, stream) -> tuple:
    """One call of the C entry at ``rows``, ``saved`` and ``blocks``,
    outside the wrapper's choice; returns (dx, grad)."""
    import torch
    from repro_torch.kernels import tt_contract as ttc
    B = x.shape[0]
    groups = ttc.grad_groups(blocks)[1]
    grad = torch.empty(spec.num_params, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    partials = torch.empty((blocks + groups) * spec.num_params,
                           device=x.device)
    err = ttc._launchers()[3](
        x.data_ptr(), dy.data_ptr(), dx.data_ptr() if need_dx else None,
        partials.data_ptr(), grad.data_ptr(),
        ttc._tickets(x.device, groups + 1).data_ptr(),
        ttc._descriptor(cores, spec).ctypes.data, B, rows, saved, blocks,
        stream)
    if err:
        raise RuntimeError(f"rows {rows} saved {saved}: CUDA error {err}")
    return dx, grad


def sweep(device, chip_smoke) -> dict:
    import dataclasses
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import tt_contract as ttc

    stream = torch.cuda.current_stream(device).cuda_stream
    out = {}
    for i, (label, (spec, B, need_dx)) in enumerate(_cases().items()):
        cores, x, dy = _inputs(spec, B, 4000 + i, device)
        want_dx, _ = ttc.tt_contract_grad(x, cores, spec, dy, need_dx)
        _, exact = ref.tt_contract_grad_ref(
            x.double(), [c.double() for c in cores], spec, dy.double(),
            False)
        _, sums = ref.tt_contract_grad_ref(
            x.double().abs(), [c.double().abs() for c in cores], spec,
            dy.double().abs(), need_dx=False)
        c = 2 * sum(max(r * n, m * rn) for r, m, n, rn in spec.core_shapes)
        row = {"tile": dataclasses.asdict(ttc.grad_tile(spec, B)),
               "configs": []}
        for saved in range(ttc.min_saved(spec), spec.L + 1):
            for rows in SWEEP_ROWS:
                smem = ttc.grad_smem_bytes(spec, rows, saved)
                if smem > ttc.SMEM_MAX_BYTES or rows > B:
                    continue
                tiles = -(-B // rows)
                per_sm = max(1, min(ttc.GRAD_BLOCKS_PER_SM,
                                    228 * 1024 // (smem + 1024)))
                blocks = min(tiles, per_sm * ttc.H100_SMS)
                dx, grad = _launch_at(x, cores, spec, dy, need_dx, rows,
                                      saved, blocks, stream)
                torch.cuda.synchronize()
                if need_dx and not torch.equal(dx, want_dx):
                    raise AssertionError(f"{label} rows {rows} saved "
                                         f"{saved}: dx differs")
                worst = 0.0
                for k, (g, e, s) in enumerate(zip(
                        grad.split([math.prod(sh) for sh in
                                    spec.core_shapes]), exact, sums)):
                    bound = 1.01 * (ttc._grad_depth(spec, k, rows, tiles,
                                                    blocks)
                                    + c) * 2.0 ** -24 * s.reshape(-1)
                    worst = max(worst, ((g.double() - e.reshape(-1)).abs()
                                        / bound).max().item())
                if not worst <= 1.0:
                    raise AssertionError(f"{label} rows {rows} saved "
                                         f"{saved}: dG at {worst} of bound")

                def call():
                    _launch_at(x, cores, spec, dy, need_dx, rows, saved,
                               blocks, stream)

                cfg = {"saved": saved, "rows": rows, "smem": smem,
                       "tiles": tiles, "blocks": blocks,
                       "worst_over_bound": worst,
                       "ms": chip_smoke._time_ms(call, 50),
                       "alone_ms": _alone(chip_smoke, call,
                                          device)["alone_ms"]}
                row["configs"].append(cfg)
                print(f"[tt-grad] sweep {label} {json.dumps(cfg)}",
                      flush=True)
        out[label] = row
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tt_grad: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if a != "--sweep"]
    src = Path(args[0]).resolve() if args else ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"tt_grad: {src} holds no checkout of the port "
              "(no repro_torch)", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import chip_smoke
    import repro_torch
    from repro_torch.kernels import _build
    _, _, card = chip_smoke.phase_device()
    lib = _build.build("tt_contract")
    ptxas = [line.strip() for line in Path(f"{lib}.log").read_text()
             .splitlines() if any(k in line for k in (
                 "entry function", "registers", "spill"))]
    for line in ptxas:
        print(f"[tt-grad] ptxas: {line}", flush=True)
    device = repro_torch.resolve_device("cuda")
    out = {"src": str(src), "ptxas": ptxas}
    if "--sweep" in sys.argv:
        out["sweep"] = sweep(device, chip_smoke)
    out.update(measure(device, chip_smoke))
    print(f"[tt-grad] {json.dumps(out)}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
