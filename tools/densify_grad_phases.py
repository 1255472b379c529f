#!/usr/bin/env python3
"""Where the grouped backward's warp design spends its time, phase by
phase, on one GPU.

    python3 tools/densify_grad_phases.py

Copies ``csrc/mesh_apply.cu`` into the build directory with a ``clock64``
stamp after each of ``mesh_densify_grad_warp_kernel``'s barriers (thread
0 of each block; at its start and its end too), builds the copy with
``nvcc`` and this checkout's flags, and launches it on the paper's 8 core
matrices (``chip_smoke.densify_inputs``, noise on) at S = 1 and 11 with
the descriptors of this checkout's wrapper (``group_template``).  Prints
per block (S = 1) and as the median over blocks the SM cycles of each
phase — the staging's global reads, the trig, V's forward, U's walks,
V's reverse walk, the outputs — beside the SM clock, checks that the
copy gives the wrapper's bits, and times the copy's launch on CUDA
events (the stamps cost a store a phase).  Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("stage reads", "trig", "V forward", "U forward + reverse",
          "V reverse", "outputs")


def instrument(src: str) -> str:
    """The source with a stamp after each barrier of the warp kernel."""
    head = src.index("mesh_densify_grad_warp_kernel(const __grid_constant__")
    start = src.index("{", head)
    end = src.index("\n}\n", start)
    count = iter(range(1, 64))
    body = re.sub(r"__syncthreads\(\);",
                  lambda _: f"__syncthreads(); STAMP({next(count)})",
                  src[start + 1:end])
    body = "{ STAMP(0)" + body + f"\n  STAMP({next(count)})"
    stamps = ("__device__ long long g_stamps[16 * 4096];\n"
              "#define STAMP(n) if (threadIdx.x == 0) g_stamps[(blockIdx.y"
              " * gridDim.x + blockIdx.x) * 16 + (n)] = clock64();\n")
    out = src[:start] + body + src[end:]
    at = out.index("constexpr int kWarpGradMaxThreads")
    return (out[:at] + stamps + out[at:]
            + '\nextern "C" int read_stamps(void* host, int n) {\n'
              "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps,"
              " n * 8));\n}\n")


def build():
    from repro_torch.kernels import _build
    from repro_torch.kernels import mesh_apply as mesh
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "mesh_apply_phases.cu"
    cu.write_text(instrument((_build.CSRC_DIR / "mesh_apply.cu").read_text()))
    lib = _build.BUILD_DIR / "libmesh_apply_phases.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    so.mesh_densify_grad_warp_launch.argtypes = [
        ctypes.POINTER(mesh.MeshGroup), ctypes.POINTER(mesh._GroupOffsets),
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    so.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return so


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("densify_grad_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import mesh_apply as mesh
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[phases] {smi}", flush=True)
    so = build()
    for S in (1, 11):
        pms, ps, nzs, model, _ = chip_smoke.densify_inputs(
            1024, 4, S, True, None, dev, 3300 + S)
        gen = torch.Generator().manual_seed(3400 + S)
        dW = [torch.randn((S, pm.out_dim, pm.in_dim), generator=gen).to(dev)
              for pm in pms]
        want = mesh.mesh_densify_grad(pms, ps, nzs, model, dW)
        tensors = [p[k] for p in ps for k in mesh.PARAM_KEYS] + dW
        tpl = mesh.group_template("backward", pms, ps, nzs, model, None,
                                  tensors, dW)
        grp = tpl.bind(tensors)
        flat = torch.empty(tpl.size, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            err = so.mesh_densify_grad_warp_launch(
                ctypes.byref(grp), ctypes.byref(tpl.offsets),
                flat.data_ptr(), tpl.warps, stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        for _ in range(20):
            launch()
        torch.cuda.synchronize()
        blocks = len(pms) * S
        buf = (ctypes.c_longlong * (16 * blocks))()
        if so.read_stamps(buf, 16 * blocks):
            raise RuntimeError("reading the stamps failed")
        rows = [[buf[b * 16 + i] - buf[b * 16 + i - 1]
                 for i in range(1, len(PHASES) + 1)] for b in range(blocks)]
        got = tpl.outputs(flat)
        same = all(torch.equal(a, b) for a, b in
                   zip(got, [t for trio in want for t in trio]))
        if not same:
            raise AssertionError("the stamped copy differs from the kernel")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            launch()
        end.record()
        torch.cuda.synchronize()
        median = [sorted(r[i] for r in rows)[len(rows) // 2]
                  for i in range(len(PHASES))]
        print(f"[phases] {json.dumps({'S': S, 'phases': PHASES, 'median_cycles': median, 'slowest_block_cycles': max(map(sum, rows)), 'blocks': rows if S == 1 else None, 'shapes': [(pm.out_dim, pm.in_dim) for pm in pms], 'bitwise_equal_kernel': same, 'per_launch_ms': start.elapsed_time(end) / 200})}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
