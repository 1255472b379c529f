#!/usr/bin/env python3
"""Where the time of the warp-rows backward's phase terms goes: an
ablation of ``mesh_rows_grad_kernel`` (``csrc/mesh_apply.cu``) on one GPU.

    python3 tools/mesh_rows_grad_ablation.py

Each variant is this checkout's source with one part cut out, written
into ``build/mesh_rows_grad_ablation/`` and built there with the port's
``nvcc`` flags (all at once), so the port's own source keeps no switch:

  * ``base``: as it is.
  * ``no-sum``: the chunks' sums over the warps cut (the block columns'
    partials are left as they were: wrong values).
  * ``no-terms``: the phase terms neither computed nor stored (the sums
    read whatever the buffer holds).
  * ``no-terms-no-sum``: both: what is left is the dx walk with the slot
    map staged beside the records.

Each runs through the C entry ``mesh_rows_grad_launch`` with the
wrapper's launch (``mesh_apply.grad_rows_config``) at onn's shapes at
hidden 1024: layer 0's U mesh on 100 and 21 rows, the dense backward's
walk on M's 1024 rows and the hidden layer's mesh on 4300 rows, with
dphases and (``base`` only) dx alone, timed on CUDA events.  Prints
``[mesh-rows-grad-ablation]`` JSON lines and the card's name and power
limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mesh_rows_grad_ablation"

SUM = [("    if (phase && k > 0) sum_chunk(k - 1);\n", "\n"),
       ("    sum_chunk(chunks - 1);\n", "\n")]
TERMS = [("      if (phase)\n        rows_terms<W, R>(", "      if (false)\n"
          "        rows_terms<W, R>(")]
VARIANTS = {"base": [], "no-sum": SUM, "no-terms": TERMS,
            "no-terms-no-sum": TERMS + SUM}
# label -> (rows, shared x)
SHAPES = {"u1024-100": 100, "u1024-21": 21, "p1024-1024": 1024,
          "p1024-4300": 4300}


def build(name: str, cuts: list) -> Path:
    from repro_torch.kernels import _build
    src = (_build.CSRC_DIR / "mesh_apply.cu").read_text()
    for old, new in cuts:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: anchor {old!r} not found once")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_rows_grad_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    _, _, card = chip_smoke.phase_device()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv),
                                           VARIANTS.items())))
    device = torch.device("cuda")
    layout = photonic.rectangular_layout(1024)
    P, L, K = layout.ports, layout.levels, layout.slots
    plan = mesh._plan_tensor(layout, device)
    smap = mesh._map_tensor(layout, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator().manual_seed(5)
    phases = torch.randn((1, L, K), generator=gen).to(device)
    diag = torch.where(torch.rand(P, generator=gen) < 0.5, -1.0, 1.0).to(
        device)
    for label, B in SHAPES.items():
        y = torch.randn((1, B, P), generator=gen).to(device)
        dy = torch.randn((1, B, P), generator=gen).to(device)
        W, R, warps, cols = mesh.grad_rows_config(layout, 1, B, sms)
        dx, dph = torch.empty_like(y), torch.empty((1, L, K), device=device)
        part = torch.empty((cols, 1, L, K), device=device)
        table = torch.empty((1, L, mesh.record_floats(W)), device=device)
        row = {"case": label, "rows": B, "rows_per_warp": R,
               "warps": warps, "block_columns": cols}
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            fn = lib.mesh_rows_grad_launch
            fn.argtypes = mesh._library().mesh_rows_grad_launch.argtypes
            fn.restype = ctypes.c_int
            for key, need_ph in ((name, True),
                                 *(((f"{name}-dx-only", False),)
                                   if name == "base" else ())):
                def launch():
                    err = fn(y.data_ptr(), dy.data_ptr(), phases.data_ptr(),
                             plan.data_ptr(), smap.data_ptr(),
                             diag.data_ptr(), dx.data_ptr(),
                             dph.data_ptr() if need_ph else None,
                             part.data_ptr() if need_ph else None,
                             table.data_ptr(), B, P, L, K, smap.shape[1], 1,
                             W, R, warps, cols, 0, 0, mesh._stream(y))
                    if err:
                        raise RuntimeError(f"{key} at {label}: CUDA error "
                                           f"{err}")
                row[f"{key}_ms"] = chip_smoke._time_ms(launch, 10, warmup=2)
        print(f"[mesh-rows-grad-ablation] {json.dumps(row)}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
