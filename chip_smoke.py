#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. device   — the card's name, count, power limit; TF32 off everywhere.
  2. build    — ``nvcc`` builds the ``tt_contract`` kernel from the sources
                in this checkout; prints ptxas' register / shared-memory line.
  3. kernel   — the kernel against its plain PyTorch version on the card at
                the paper's spec (B = 2048, the served pool, and 65,536), the
                reduced config's spec at a B that is not a multiple of the
                tile, and a rank-4 non-square spec; bound
                ``max|kernel − plain| ≤ 1e-5·max|plain| + 1e-6`` (f32 sums in
                another order).  At the paper's spec it times the kernel, the
                plain version and ``x @ tt_to_full(cores).T`` (the one-call
                library yardstick) with CUDA events.
  4. serve    — the port's main path through the entry points a user calls:
                ``SolverRegistry.register_fresh`` of the paper's solver
                (hjb-20d, tonn, hidden 1024, ranks [1,2,1,2,1], noise on) and
                heat-10d (tt, hidden 1024), a ``PdeServingEngine`` of 8×256
                slots, 31 mixed requests incl. one larger than the pool, then
                an exact repeat that the cache answers.  Checks: all done and
                finite, served values equal a direct ``model.u`` (rtol =
                atol = 1e-6: the head's matmul may pick another cuBLAS
                algorithm per batch size), the same forward on the CPU (plain
                path, rtol = atol = 1e-5), two programs built, and two kernel
                launches per program run.
  5. report   — one ``{"kernels": [...]}`` line, the card's name and power
                limit, then ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device, or run outside a checkout of the repository, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores — the rates the TT chain's f32 FMAs run at.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def _time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of one call over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(spec, batch: int) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over bandwidth (x read
    once, y written once, cores read once) and FLOPs over the f32 peak."""
    bytes_moved = 4 * (batch * spec.in_dim + batch * spec.out_dim
                       + spec.num_params)
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = spec.contraction_flops(batch) / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {name} x{count}; nvidia-smi: {card}", flush=True)
    return name, count, card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build("tt_contract")
    _build.load_library("tt_contract")
    ptxas = [line.strip() for line in
             Path(f"{lib}.log").read_text().splitlines()
             if "registers" in line or "smem" in line or "spill" in line]
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s "
          f"(cached builds take no time)", flush=True)
    for line in ptxas:
        print(f"[build] ptxas: {line}", flush=True)


def phase_kernel(device) -> dict:
    import torch
    from repro_torch.core import tt
    from repro_torch.kernels import ref, tt_contract as ttc

    cases = [("paper", tt.PAPER_TONN_SPEC, 2048, True),
             ("paper", tt.PAPER_TONN_SPEC, 65536, True),
             ("reduced-64", tt.auto_factorize(64, 64, L=3, max_rank=2), 1000,
              False),
             ("rank4-256x512", tt.auto_factorize(256, 512, L=3, max_rank=4),
              777, False)]
    results = []
    for i, (label, spec, batch, timed) in enumerate(cases):
        gen = torch.Generator().manual_seed(1000 + i)
        cores = [c.to(device) for c in tt.tt_init(gen, spec)]
        x = torch.randn((batch, spec.in_dim), generator=gen).to(device)
        y_k = ttc.tt_contract(x, cores, spec)
        y_p = ref.tt_contract_ref(x, cores, spec)
        torch.cuda.synchronize()
        err = (y_k - y_p).abs().max().item()
        scale = y_p.abs().max().item()
        tol = 1e-5 * scale + 1e-6
        if not (torch.isfinite(y_k).all().item() and err <= tol):
            raise AssertionError(
                f"tt_contract disagrees with its plain version at {label} "
                f"B={batch}: max|diff| {err:.3e} > {tol:.3e}")
        row = {"spec": label, "modes": [list(spec.out_modes),
                                        list(spec.in_modes)],
               "ranks": list(spec.ranks), "batch": batch,
               "rows_per_block": ttc.rows_per_block(spec),
               "max_abs_err": err, "max_abs_plain": scale}
        if timed:
            w = tt.tt_to_full(cores, spec)
            iters = 200 if batch <= 4096 else 20
            row["ms"] = _time_ms(lambda: ttc.tt_contract(x, cores, spec), iters)
            row["plain_ms"] = _time_ms(
                lambda: ref.tt_contract_ref(x, cores, spec), iters)
            row["library_ms"] = _time_ms(lambda: torch.matmul(x, w.T), iters)
            row["bound_ms"], row["bound_by"] = _bound(spec, batch)
            row["bound_us"] = row["bound_ms"] * 1e3
        results.append(row)
        print(f"[kernel] {json.dumps(row)}", flush=True)
    return {"cases": results}


def phase_serve(device) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import pinn
    from repro_torch.core.photonic import NoiseModel
    from repro_torch.device import to_device
    from repro_torch.kernels import tt_contract as ttc
    from repro_torch.serving import (PdeServingEngine, PointRequest,
                                     SolverRegistry)

    # the paper's on-chip fused config (repro/configs/hjb_pinn.py,
    # TONN_ONCHIP_FUSED) and the second solver of the mixed traffic
    cfgs = {
        "hjb": pinn.PINNConfig(hidden=1024, mode="tonn", tt_rank=2, tt_L=4,
                               deriv="fd_fast", use_fused_kernel=True,
                               noise=NoiseModel(enabled=True),
                               pde="hjb-20d"),
        "heat": pinn.PINNConfig(hidden=1024, mode="tt", tt_rank=2, tt_L=4,
                                use_fused_kernel=True, pde="heat-10d"),
    }
    reg = SolverRegistry(device=device)
    for seed, (name, cfg) in enumerate(cfgs.items()):
        reg.register_fresh(name, cfg, seed=seed, device=device)
    engine = PdeServingEngine(reg, slots=8, slot_points=256, device=device)

    rng = np.random.RandomState(0)
    names = reg.names()
    traffic = []
    for i in range(30):
        name = names[i % 2]
        n = int(rng.randint(1, 257))
        traffic.append((name, rng.uniform(
            0.02, 0.98, (n, reg.get(name).in_dim)).astype(np.float32)))
    traffic.append(("hjb", rng.uniform(0.02, 0.98, (3000, 21)).astype(
        np.float32)))                                    # larger than the pool

    ttc.tt_contract.launches = 0                          # main path starts
    t_warm = time.perf_counter()
    engine.warmup()
    t_warm = time.perf_counter() - t_warm
    t0 = time.perf_counter()
    reqs = [engine.submit(PointRequest(name, pts)) for name, pts in traffic]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # an exact repeat is answered by the cache at submit, without a program
    repeat = engine.submit(PointRequest(*traffic[0]))
    launches = ttc.tt_contract.launches                   # main path ends

    stats = engine.serving_stats()
    expected = 2 * (len(names) + stats["program_runs"])
    if launches != expected:
        raise AssertionError(f"tt_contract launched {launches} times, "
                             f"expected {expected} (2 per program run)")
    if stats["compiles"] != len(names):
        raise AssertionError(f"{stats['compiles']} programs built, "
                             f"expected {len(names)}")
    if not repeat.done or stats["cache_hits"] != len(traffic[0][1]):
        raise AssertionError(f"the repeated request missed the cache: "
                             f"{stats['cache_hits']} hits")
    reqs.append(repeat)
    # time per full-pool program call, back to back on CUDA events (2
    # kernels plus the elementwise ops and the head; the host's launch
    # rate can bound it), beside the host clock's time per engine step
    program_ms = {}
    for name in names:
        s = reg.get(name)
        pool = s.problem.sample_collocation(
            torch.Generator().manual_seed(1),
            engine.slots * engine.slot_points).to(device)
        with torch.no_grad():
            program_ms[name] = _time_ms(lambda: s.model.u(s.params, pool), 50)
    worst = 0.0
    for r in reqs:
        if not (r.done and r.out.shape == (len(r.points),)
                and np.isfinite(r.out).all()):
            raise AssertionError(f"request for {r.solver} not served")
        s = reg.get(r.solver)
        with torch.no_grad():
            direct = s.model.u(s.params, torch.tensor(
                r.points, dtype=torch.float32, device=device)).cpu().numpy()
        np.testing.assert_allclose(r.out, direct, rtol=1e-6, atol=1e-6)
        worst = max(worst, float(np.abs(r.out - direct).max()))
    # the same forward through the plain path on the CPU
    cpu_err = 0.0
    for r in reqs[:2]:
        s = reg.get(r.solver)
        params = to_device(s.params, torch.device("cpu"))
        with torch.no_grad():
            ref_u = s.model.u(params, torch.tensor(
                r.points, dtype=torch.float32)).numpy()
        np.testing.assert_allclose(r.out, ref_u, rtol=1e-5, atol=1e-5)
        cpu_err = max(cpu_err, float(np.abs(r.out - ref_u).max()))

    lat_ms = np.asarray([r.latency_s for r in reqs[:-1]]) * 1e3
    points = sum(len(r.points) for r in reqs[:-1])
    out = {"requests": len(reqs) - 1, "points": points,
           "warmup_s": t_warm, "wall_ms": wall * 1e3,
           "points_per_s": points / wall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "max_abs_served_vs_direct": worst,
           "max_abs_served_vs_cpu": cpu_err,
           "step_ms": wall * 1e3 / stats["steps"],
           "program_ms": program_ms,
           "launches": launches,
           "stats": {k: stats[k] for k in ("compiles", "program_runs",
                                           "steps", "cache_hits",
                                           "points_served",
                                           "points_padded")}}
    print(f"[serve] {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(no src/repro_torch)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch

    name, count, card = phase_device()
    phase_build()
    device = repro_torch.resolve_device("cuda")
    kernel = phase_kernel(device)
    serve = phase_serve(device)

    main_case = kernel["cases"][0]                       # paper spec, B=2048
    entry = {"name": "tt_contract", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/tt_contract.cu",
             "replaces": "src/repro/kernels/tt_contract.py:95",
             "launches": serve["launches"],
             "max_abs_err": main_case["max_abs_err"],
             "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
             "bound_ms": main_case["bound_ms"],
             "bound_by": main_case["bound_by"],
             "library_ms": main_case["library_ms"],
             "shape": "x (2048, 1024) f32, PAPER_TONN_SPEC",
             "cases": kernel["cases"]}
    print(f"[serve] p50 {serve['p50_ms']:.3f} ms, p99 {serve['p99_ms']:.3f} "
          f"ms, {serve['points_per_s']:.0f} points/s over "
          f"{serve['requests']} requests on {card}", flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
