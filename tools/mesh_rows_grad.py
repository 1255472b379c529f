#!/usr/bin/env python3
"""The wide meshes' backwards (``mesh_apply.mesh_apply_stacked_grad``:
the warp-rows and the dense designs) on one GPU: their ptxas lines, their
checks against the plain versions, the walk's launch configurations, and
the walk of any checkout of the port.

    python3 tools/mesh_rows_grad.py [--quick]
    python3 tools/mesh_rows_grad.py --walk SRC

  * ptxas: registers, shared memory and spills of every instance of
    ``mesh_rows_grad_kernel`` and of the product kernels
    (``mesh_product_kernel``, ``mesh_product_grad_kernel``) in
    ``csrc/mesh_apply.cu``, from the build log.
  * checks: ``chip_smoke.phase_mesh_grad`` and ``mesh_grad_wide_cases``
    (every mesh backward against its plain version within 1e-4 of
    max|plain|, two calls bit for bit, the timed cases on CUDA events and
    alone in a trace, beside the bound, the plain version and autograd of
    the plain forward; the dense backward in turns with the warp-rows one
    on the same forward).
  * configs (skipped with ``--quick``): the C entry
    ``mesh_rows_grad_launch`` at onn's BP launches at hidden 1024 (the
    hidden layer's U mesh on 4300 rows, the dense backward's walk on M's
    1024 identity rows, layer 0's on 100 and 21) at rows per warp and
    warps per block around ``mesh_apply.grad_rows_config``'s choice: each
    against the wrapper's bits (dx and dphases), timed on CUDA events,
    with its block columns and scratch.
  * ``--walk SRC``: the warp-rows backward of the ``repro_torch`` under
    SRC (a ``git archive`` of another commit, or this checkout's ``src``)
    handed y and dy at those four shapes, with dphases and dx alone (the
    walk without its phase terms: the floor of its two level
    applications), on CUDA events, the same inputs from seeds in every
    checkout.  Run parent, change, change, parent, each a process.

Prints one ``[mesh-rows-grad]`` JSON line and the card's name and power
limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# label -> (S, rows, shared x, (rows per warp, warps) to try)
CONFIGS = {
    "p1024-4300": (1, 4300, False, ((1, 4), (1, 8), (2, 4), (2, 8))),
    "p1024-1024": (1, 1024, False, ((1, 4), (1, 8), (2, 4), (2, 8))),
    "u1024-100": (1, 100, True, ((1, 1), (1, 2), (1, 4), (1, 8))),
    "u1024-21": (1, 21, True, ((1, 1), (1, 2), (1, 4))),
}


def ptxas_lines() -> list:
    from repro_torch.kernels import _build
    log = Path(f"{_build.build('mesh_apply')}.log").read_text().splitlines()
    out, keep = [], False
    for line in log:
        if "Compiling entry function" in line:
            keep = "mesh_rows_grad_kernel" in line or "mesh_product" in line
        if keep:
            out.append(line.strip())
    return out


def configs(device) -> list:
    import chip_smoke
    import torch
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    layout = photonic.rectangular_layout(1024)
    P, L, K = layout.ports, layout.levels, layout.slots
    W = mesh.lane_width(P)
    smap = mesh._map_tensor(layout, device)
    plan = mesh._plan_tensor(layout, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = []
    for label, (S, B, shared, tries) in CONFIGS.items():
        gen = torch.Generator().manual_seed(len(label))
        phases = torch.randn((S, L, K), generator=gen).to(device)
        diag = torch.where(torch.rand((S, P), generator=gen) < 0.5, -1.0,
                           1.0).to(device)
        x = torch.randn((B, P) if shared else (S, B, P),
                        generator=gen).to(device)
        y = mesh.mesh_apply_stacked(layout, phases, diag, x)
        dy = torch.randn(y.shape, generator=gen).to(device)
        want = mesh.mesh_apply_stacked_grad(layout, phases, diag, y, dy)
        chosen = mesh.grad_rows_config(layout, S, B, sms)
        for R, warps in tries:
            cols = -(-B // (warps * R))
            dx = torch.empty_like(y)
            dph = torch.empty((S, L, K), device=device)
            part = torch.empty((cols, S, L, K), device=device)
            table = torch.empty((S, L, mesh.record_floats(W)), device=device)

            def launch():
                err = mesh._library().mesh_rows_grad_launch(
                    y.data_ptr(), dy.data_ptr(), phases.data_ptr(),
                    plan.data_ptr(), smap.data_ptr(), diag.data_ptr(),
                    dx.data_ptr(), dph.data_ptr(), part.data_ptr(),
                    table.data_ptr(), B, P, L, K, smap.shape[1], S, W, R,
                    warps, cols, P, 0, mesh._stream(y))
                if err:
                    raise RuntimeError(f"{label} R {R} warps {warps}: CUDA "
                                       f"error {err}")
            launch()
            torch.cuda.synchronize()
            # the phase sums run over other row groupings: within the f32
            # bound of the wrapper's, dx bit for bit
            err = (dph - want[1]).abs().max().item()
            scale = want[1].abs().max().item()
            if not (torch.equal(dx, want[0]) and err <= 1e-5 * scale):
                raise AssertionError(f"{label} R {R} warps {warps}: dx equal "
                                     f"{torch.equal(dx, want[0])}, dphases "
                                     f"{err:.3e} of {scale:.3e}")
            out.append({"case": label, "rows_per_warp": R, "warps": warps,
                        "block_columns": cols,
                        "scratch_mib": 4 * cols * S * L * K / 2**20,
                        "chosen": (R, warps) == chosen[1:3],
                        "ms": chip_smoke._time_ms(launch, 10, warmup=2)})
            print(f"[mesh-rows-grad] {json.dumps(out[-1])}", flush=True)
    return out


def walk(device, chip_smoke) -> list:
    """The warp-rows backward of the imported port handed y and dy at
    ``CONFIGS``' shapes: per call on CUDA events, with dphases and with
    dx alone."""
    import torch
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    layout = photonic.rectangular_layout(1024)
    P, L, K = layout.ports, layout.levels, layout.slots
    out = []
    for label, (S, B, shared, _) in CONFIGS.items():
        gen = torch.Generator().manual_seed(len(label))
        phases = torch.randn((S, L, K), generator=gen).to(device)
        diag = torch.where(torch.rand((S, P), generator=gen) < 0.5, -1.0,
                           1.0).to(device)
        y = torch.randn((S, B, P), generator=gen).to(device)
        dy = torch.randn((S, B, P), generator=gen).to(device)
        row = {"case": label, "rows": B}
        for key, need_ph in (("ms", True), ("dx_only_ms", False)):
            row[key] = chip_smoke._time_ms(
                lambda: mesh.mesh_apply_stacked_grad(
                    layout, phases, diag, y, dy, False, True, need_ph),
                10, warmup=2)
        out.append(row)
        print(f"[mesh-rows-grad] walk {json.dumps(row)}", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_rows_grad: no CUDA device", file=sys.stderr)
        return 2
    if "--walk" in sys.argv:
        src = Path(sys.argv[sys.argv.index("--walk") + 1]).resolve()
        sys.path[:0] = [str(src), str(ROOT)]
        import chip_smoke
        import repro_torch
        _, _, card = chip_smoke.phase_device()
        out = walk(repro_torch.resolve_device("cuda"), chip_smoke)
        print(f"[mesh-rows-grad] {json.dumps({'src': str(src), 'walk': out})}",
              flush=True)
        print(card, flush=True)
        return 0
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    import repro_torch
    device = repro_torch.resolve_device("cuda")
    _, _, card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    for line in ptxas_lines():
        print(f"[ptxas] {line}", flush=True)
    result = {"checks": {**chip_smoke.phase_mesh_grad(device),
                         **chip_smoke.mesh_grad_wide_cases(device)}}
    if "--quick" not in sys.argv:
        result["configs"] = configs(device)
    print(f"[mesh-rows-grad] {json.dumps(result)}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
