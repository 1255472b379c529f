#!/usr/bin/env python3
"""Where the resident backward's warp design spends its time, phase by
phase, on one GPU.

    python3 tools/mesh_apply_grad_phases.py

Copies ``csrc/mesh_apply.cu`` into the build directory with a ``clock64``
stamp after each of ``mesh_apply_grad_warp_kernel``'s barriers (thread 0
of each block; at its start and at every return too), builds the copy
with ``nvcc`` and this checkout's flags, and launches it through its C
entry at ``chip_smoke.MESH_GRAD_CASES``' ``p64-4300``, ``v21-100-tr``
and ``v21-4300-tr`` with the launch ``resident_grad_warp_config`` gives,
dphases asked for and not.  Prints the median over blocks and the
slowest block's SM cycles of each phase — the staging's reads and trig,
the lane records, the walk (its slowest warp), the warps' sums and the
columns' write or fold — beside the SM clock, checks that the copy gives
the wrapper's bits, and times the copy's launch on CUDA events (the
stamps cost a store a phase).  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("stage reads + trig", "records", "walk", "sums + write / fold")
CASES = ("p64-4300", "v21-100-tr", "v21-4300-tr")
END = 15


def instrument(src: str) -> str:
    """The source with a stamp after each barrier of the warp kernel and
    at its returns."""
    head = src.index("mesh_apply_grad_warp_kernel(const float* __restrict__")
    start = src.index("{", head)
    end = src.index("\n}\n", start)
    count = iter(range(1, END))
    body = re.sub(r"__syncthreads\(\);",
                  lambda _: f"__syncthreads(); STAMP({next(count)})",
                  src[start + 1:end])
    body = body.replace("return;", f"{{ STAMP({END}) return; }}")
    body = "{ STAMP(0)" + body + f"\n  STAMP({END})"
    stamps = ("__device__ long long g_stamps[16 * 8192];\n"
              "#define STAMP(n) if (threadIdx.x == 0) g_stamps[(blockIdx.y"
              " * gridDim.x + blockIdx.x) * 16 + (n)] = clock64();\n")
    out = src[:start] + body + src[end:]
    at = out.index("constexpr int kResWarpMaxThreads")
    return (out[:at] + stamps + out[at:]
            + '\nextern "C" int read_stamps(void* host, int n) {\n'
              "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps,"
              " n * 8));\n}\n")


def build():
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "mesh_apply_grad_phases.cu"
    cu.write_text(instrument((_build.CSRC_DIR / "mesh_apply.cu").read_text()))
    lib = _build.BUILD_DIR / "libmesh_apply_grad_phases.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    so.mesh_apply_grad_warp_launch.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int] * 10 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    so.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return so


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_apply_grad_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]
    import chip_smoke
    import mesh_apply_grad
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[phases] {smi}", flush=True)
    so = build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label in CASES:
        layout, phases, diag, _, y, dy, tr, S, B, _ = mesh_apply_grad.inputs(
            chip_smoke, dev, label)
        P, L, K = layout.ports, layout.levels, layout.slots
        pairs, _, warps, cols, per, chunk, fold = \
            mesh.resident_grad_warp_config(layout, S, B, sms)
        plan = photonic.mesh_plan_tensors(layout, dev)
        for need_ph in (True, False):
            want = mesh.mesh_apply_stacked_grad(layout, phases, diag, y, dy,
                                                tr, need_dphases=need_ph)
            dx = torch.empty_like(y)
            dph = torch.empty((S, L, K), device=dev) if need_ph else None
            part = (torch.empty((cols, S, L, K), device=dev)
                    if need_ph and cols > 1 else None)
            tickets = torch.zeros(max(S, 64), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                err = so.mesh_apply_grad_warp_launch(
                    y.data_ptr(), dy.data_ptr(), phases.data_ptr(),
                    plan["slot_i32"].data_ptr(), plan["sign"].data_ptr(),
                    plan["perm"].data_ptr(), diag.data_ptr(), dx.data_ptr(),
                    None if dph is None else dph.data_ptr(),
                    None if part is None else part.data_ptr(),
                    tickets.data_ptr() if fold else None, B, P, L, K, S,
                    warps, cols, per, chunk, int(pairs), P, int(tr), stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            for _ in range(20):
                launch()
            torch.cuda.synchronize()
            blocks = cols * S
            buf = (ctypes.c_longlong * (16 * blocks))()
            if so.read_stamps(buf, 16 * blocks):
                raise RuntimeError("reading the stamps failed")
            marks = (0, 1, 2, 3, END)
            rows = [[buf[b * 16 + marks[i]] - buf[b * 16 + marks[i - 1]]
                     if need_ph or i < 4 else None
                     for i in range(1, len(marks))] for b in range(blocks)]
            if not need_ph:      # no barrier after the walk: it ends there
                rows = [[r[0], r[1], buf[b * 16 + END] - buf[b * 16 + 2],
                         0] for b, r in enumerate(rows)]
            same = torch.equal(dx, want[0]) and (
                not need_ph or torch.equal(dph, want[1]))
            if not same:
                raise AssertionError(f"{label}: the stamped copy differs "
                                     "from the kernel")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(200):
                launch()
            end.record()
            torch.cuda.synchronize()
            median = [sorted(r[i] for r in rows)[len(rows) // 2]
                      for i in range(len(PHASES))]
            print(f"[phases] {json.dumps({'case': label, 'dphases': need_ph, 'phases': PHASES, 'median_cycles': median, 'slowest_block_cycles': max(map(sum, rows)), 'slowest_block': max(rows, key=sum), 'warps': warps, 'columns': cols, 'groups_per_column': per, 'chunk': chunk, 'fold': fold, 'bitwise_equal_kernel': same, 'per_launch_ms': start.elapsed_time(end) / 200})}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
