#!/usr/bin/env python3
"""The wide-mesh routes of ``mesh_apply_stacked`` on one GPU: their ptxas
lines, a check of each against the plain version, route A's launch
configurations, and the crossover between route A and route B.

    python3 tools/mesh_wide.py

  * ptxas: registers, shared memory and spills of every kernel of
    ``csrc/mesh_apply.cu``, from its build log.
  * checks: route A (``launch_warp_rows``) bit for bit against
    ``photonic.mesh_apply_stacked`` on 1024 ports (per entry, transposed),
    160 ports at B 777 and a Reck layout of 256 ports; route B
    (``launch_dense``) within ``1e-5·max|plain| + 1e-6`` at 1024 ports, S
    3, B 1100 and 160 ports at B 777 (x shared, transposed).
  * configs: route A through ``mesh_rows_launch`` at onn's launches (the
    hidden layer's 11 x 4300 rows per entry, layer 0's 11 x 100 and
    11 x 21) at rows per warp and warps per block around
    ``mesh_apply.rows_config``'s choice, bit for bit, each timed on CUDA
    events and its two kernels (the trig prologue, the rows) alone in a
    trace.
  * crossover: route A against route B on 1024 ports, x per entry, at
    B in {256, 512, 1024, 2048, 4300} rows per entry, S = 11 and S = 1.

Prints one ``[mesh-wide]`` JSON line and the card's name and power limit.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CROSSOVER_ROWS = (256, 512, 1024, 2048, 4300)


def _inputs(layout, S, B, shared, seed, device):
    import torch
    gen = torch.Generator().manual_seed(seed)
    P = layout.ports
    phases = 0.1 * torch.randn((S, *layout.phase_shape()), generator=gen)
    diag = torch.where(torch.rand((S, P), generator=gen) < 0.5, -1.0, 1.0)
    x = torch.randn((B, P) if shared else (S, B, P), generator=gen)
    return phases.to(device), diag.to(device), x.to(device)


def _reck(P):
    import numpy as np
    from repro_torch.core import photonic
    q, _ = np.linalg.qr(np.random.RandomState(P).standard_normal((P, P)))
    return photonic.decompose_orthogonal(q)[0]


def checks(device) -> list:
    import torch
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    rect = photonic.rectangular_layout
    out = []
    for label, layout, S, B, shared, tr, route in (
            ("a-1024-tr", rect(1024), 3, 37, False, True, "warp_rows"),
            ("a-160-777", rect(160), 3, 777, False, False, "warp_rows"),
            ("a-reck256", _reck(256), 2, 19, False, True, "warp_rows"),
            ("b-1024-1100", rect(1024), 3, 1100, False, False, "dense"),
            ("b-160-777-shared-tr", rect(160), 3, 777, True, True, "dense")):
        phases, diag, x = _inputs(layout, S, B, shared, len(label), device)
        launch = (mesh.launch_warp_rows if route == "warp_rows"
                  else mesh.launch_dense)
        y = launch(layout, phases, diag, x, tr)
        plain = photonic.mesh_apply_stacked(layout, phases, diag, x, tr)
        torch.cuda.synchronize()
        err = (y - plain).abs().max().item()
        bound = 1e-5 * plain.abs().max().item() + 1e-6
        equal = bool(torch.equal(y, plain))
        row = {"case": label, "route": route, "max_abs_err": err,
               "bound": bound, "bitwise_equal": equal}
        out.append(row)
        if not (err <= bound and (equal or route == "dense")):
            raise AssertionError(f"mesh-wide check {row}")
    return out


def configs(device, time_ms, chip_smoke) -> list:
    """Route A through its C entry at onn's launches (the hidden layer's 11
    x 4300 rows per entry, layer 0's 11 x 100 and 11 x 21) with rows per
    warp and warps per block around ``rows_config``'s choice, each bit for
    bit against the plain version and timed on CUDA events."""
    import torch
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    layout = photonic.rectangular_layout(1024)
    P, L = layout.ports, layout.levels
    plan = mesh._plan_tensor(layout, device)
    lib = mesh._library()
    out = []
    for label, S, B, shared, tried in (
            ("hidden-11x4300", 11, 4300, False,
             ((4, 4), (4, 8), (4, 2), (2, 4))),
            ("layer0-11x100", 11, 100, True,
             ((1, 4), (1, 8), (1, 2), (2, 4))),
            ("layer0-11x21", 11, 21, True, ((1, 4), (1, 8), (1, 2)))):
        phases, diag, x = _inputs(layout, S, B, shared, B, device)
        W = mesh.lane_width(P)
        plain = photonic.mesh_apply_stacked(layout, phases, diag, x)
        row = {"case": label, "rows_config": list(mesh.rows_config(
            layout, S, B, mesh._sm_count(device))), "ms": {}}
        for R, nw in tried:
            y = torch.empty((S, B, P), device=device)
            table = torch.empty((S, L, mesh.record_floats(W)), device=device)

            def run():
                err = lib.mesh_rows_launch(
                    x.data_ptr(), phases.data_ptr(), plan.data_ptr(),
                    diag.data_ptr(), y.data_ptr(), table.data_ptr(), B, P, L,
                    layout.slots, S, W, R, nw, 0 if shared else B * P, P, 0,
                    0, torch.cuda.current_stream(device).cuda_stream)
                if err:
                    raise RuntimeError(f"mesh_rows_launch: CUDA error {err}")

            key = f"R{R}-warps{nw}"
            row["ms"][key] = time_ms(run, 10 if B > 1000 else 50, warmup=2)
            fill = torch.empty(1 << 20, device=device)
            # each kernel alone (the prologue, then the rows), in a trace
            # that starts on a fill (the profiler may drop its first kernel)
            row.setdefault("kernel_each_ms", {})[key] = chip_smoke._profile(
                run, match="mesh_", lead=lambda: fill.fill_(0.0))[
                    "match_each_ms"]
            torch.cuda.synchronize()
            if not torch.equal(y, plain):
                raise AssertionError(f"route A at {label}, R {R}, {nw} "
                                     "warps: not the plain bits")
        out.append(row)
        print(f"[mesh-wide] config {json.dumps(row)}", flush=True)
    return out


def crossover(device, time_ms) -> list:
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    layout = photonic.rectangular_layout(1024)
    out = []
    for S in (11, 1):
        for B in CROSSOVER_ROWS:
            phases, diag, x = _inputs(layout, S, B, False, B + S, device)
            row = {"S": S, "rows": B}
            for route, launch in (("warp_rows", mesh.launch_warp_rows),
                                  ("dense", mesh.launch_dense),
                                  ("warp_rows", mesh.launch_warp_rows),
                                  ("dense", mesh.launch_dense)):
                row.setdefault(f"{route}_ms", []).append(time_ms(
                    lambda: launch(layout, phases, diag, x), 5, warmup=1))
            row["faster"] = min(("warp_rows", "dense"),
                                key=lambda r: min(row[f"{r}_ms"]))
            out.append(row)
            print(f"[mesh-wide] crossover {json.dumps(row)}", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_wide: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    import repro_torch
    from repro_torch.kernels import _build
    _, _, card = chip_smoke.phase_device()
    lib = _build.build("mesh_apply")
    ptxas = [line.strip() for line in Path(f"{lib}.log").read_text()
             .splitlines() if any(k in line for k in (
                 "entry function", "registers", "spill"))]
    for line in ptxas:
        print(f"[mesh-wide] ptxas: {line}", flush=True)
    device = repro_torch.resolve_device("cuda")
    out = {"checks": checks(device)}
    print(f"[mesh-wide] checks {json.dumps(out['checks'])}", flush=True)
    out["configs"] = configs(device, chip_smoke._time_ms, chip_smoke)
    out["crossover"] = crossover(device, chip_smoke._time_ms)
    print(f"[mesh-wide] {json.dumps(out)}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
