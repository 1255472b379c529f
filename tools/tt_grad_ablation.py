#!/usr/bin/env python3
"""Where the time of ``tt_contract_grad`` goes: an ablation on one GPU of
the earlier two-kernel design, or of this checkout's.

    python3 tools/tt_grad_ablation.py PARENT_SRC
    python3 tools/tt_grad_ablation.py --this

Each variant is a source with one part cut out or changed, written into
``build/tt_grad_ablation/`` and built there with the port's ``nvcc`` flags
(all at once), so the port's own source keeps no switch.

PARENT_SRC is the ``src`` of a checkout whose ``csrc/tt_contract.cu`` holds
the two-kernel backward (a block pass that recomputes each A_k from x, a
64-register shuffle tree per k, and a second kernel that sums the blocks'
partials); its variants:

  * ``base``: as it is.
  * ``no-recompute``: x loaded once, for k = L-1, and no forward step run
    (the reverse sweep reads whatever the buffer holds: wrong values, the
    right traffic less the recomputation).
  * ``no-tree``: the shuffle tree of the per-block reduction cut (each
    group's lane 0 keeps its own sum).
  * ``no-recompute-no-tree``: both.
  * ``no-sum``: ``base`` without the second kernel.

Each runs the hidden layer of a BP step (4300 rows with dx, at 8 rows a
block as that design picks, and at 16) and layer 0 (100 rows and 21
columns, no dx, 1 row a block), timed on CUDA events over back-to-back
calls and, for the block pass, alone in a trace.

``--this`` takes this checkout's one-kernel backward, with its variants:

  * ``b3``: as it is, ``__launch_bounds__(128, 3)``.
  * ``b4``, ``b5``: 4 or 5 blocks an SM (128 or 102 registers a thread),
    at layouts whose shared memory lets that many blocks share an SM.
  * ``no-sum``: ``b3`` without the tickets and the two-level sum (the
    blocks' partials left unsummed).

each at the hidden layer's and layer 0's launches, alone in a trace.
Prints ``[tt-grad-ablation]`` JSON lines and the card's name and power
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
OUT = ROOT / "build" / "tt_grad_ablation"

# (anchor in the source, its replacement) for each cut
RECOMPUTE = [
    ("    move_tile<true>(xs, f0, nrows, chain.in_dim, fc.x, fc.stride, tid);",
     "    if (k == chain.L - 1)\n"
     "      move_tile<true>(xs, f0, nrows, chain.in_dim, fc.x, fc.stride, "
     "tid);"),
    ("for (int s = 0; s < k; ++s) {", "for (int s = 0; s < 0; ++s) {")]
TREE = [("for (int off = W / 2; off > 0; off /= 2) {",
         "for (int off = 0; off > 0; off /= 2) {")]
SUM = [("  const int floats = gc.partial_floats;",
        "  return static_cast<int>(cudaSuccess);\n"
        "  const int floats = gc.partial_floats;")]
VARIANTS = {"base": [], "no-recompute": RECOMPUTE, "no-tree": TREE,
            "no-recompute-no-tree": RECOMPUTE + TREE, "no-sum": SUM}
# (label, rows, need_dx, rows a block)
CASES = (("hidden-stencil", 4300, True, 8), ("hidden-stencil-16", 4300, True,
                                              16),
         ("layer0-rows", 100, False, 1), ("layer0-columns", 21, False, 1))


BOUNDS = ("template <int kCap>\n__global__ void __launch_bounds__("
          "kFiberThreads, 3)\ntt_contract_grad_kernel(")
THIS_VARIANTS = {
    "b3": [],
    "b4": [(BOUNDS, BOUNDS.replace(", 3)", ", 4)"))],
    "b5": [(BOUNDS, BOUNDS.replace(", 3)", ", 5)"))],
    "no-sum": [("  int* last = reinterpret_cast<int*>(red);",
                "  return;\n  int* last = reinterpret_cast<int*>(red);")]}
# blocks an SM of each variant, and (saved, rows) at the hidden call
THIS_LAYOUT = {"b3": (3, (3, 4)), "b4": (4, (3, 3)), "b5": (5, (2, 3)),
               "no-sum": (3, (3, 4))}


def build(src: Path, variants: dict, nvcc_flags, nvcc: str) -> dict:
    source = (src / "repro_torch" / "kernels" / "csrc" /
              "tt_contract.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, cuts = item
        text = source
        for old, new in cuts:
            if old not in text:
                raise ValueError(f"{name}: anchor {old!r} not in the source")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        lib = OUT / f"lib{name}.so"
        proc = subprocess.run([nvcc, *nvcc_flags, "-o", str(lib), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
        log = (proc.stdout + proc.stderr).splitlines()
        ptxas = [line.strip() for i, line in enumerate(log)
                 if "registers" in line and any(
                     "grad_kernel" in prev for prev in log[max(0, i - 3):i])]
        print(f"[tt-grad-ablation] {name} ptxas {ptxas}", flush=True)
        return name, lib

    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(one, variants.items()))


def measure(libs: dict, device, chip_smoke) -> dict:
    import torch
    from repro_torch.core import tt
    from repro_torch.kernels import tt_contract as ttc

    spec = tt.PAPER_TONN_SPEC
    stream = torch.cuda.current_stream(device).cuda_stream
    out = {}
    for label, B, need_dx, rows in CASES:
        gen = torch.Generator().manual_seed(4000)
        cores = [c.to(device) for c in tt.tt_init(gen, spec)]
        x = torch.randn((B, spec.in_dim), generator=gen).to(device)
        dy = torch.randn((B, spec.out_dim), generator=gen).to(device)
        dx = torch.empty_like(x)
        grad = torch.empty(spec.num_params, device=device)
        blocks = -(-B // rows)
        partials = torch.empty(blocks * spec.num_params, device=device)
        desc = ttc._descriptor(cores, spec)
        row = {"rows": B, "rows_a_block": rows, "blocks": blocks}
        for name, path in libs.items():
            fn = ctypes.CDLL(str(path)).tt_contract_grad_launch
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call():
                err = fn(x.data_ptr(), dy.data_ptr(),
                         dx.data_ptr() if need_dx else None,
                         partials.data_ptr(), grad.data_ptr(),
                         desc.ctypes.data, B, rows, int(need_dx), stream)
                if err:
                    raise RuntimeError(f"{name} {label}: CUDA error {err}")

            trace = chip_smoke._profile(
                call, 5, match="tt_contract_grad_kernel",
                lead=lambda: torch.zeros(1, device=device))
            row[name] = {"ms": chip_smoke._time_ms(call, 50),
                         "block_pass_alone_ms":
                             None if trace["match_ms"] is None
                             else trace["match_ms"] / trace["match_kernels"]}
        out[label] = row
        print(f"[tt-grad-ablation] {label} {json.dumps(row)}", flush=True)
    return out


def measure_this(libs: dict, device, chip_smoke) -> dict:
    """This checkout's variants at the hidden call and layer 0's, alone in
    a trace."""
    import torch
    from repro_torch.core import tt
    from repro_torch.kernels import tt_contract as ttc

    spec = tt.PAPER_TONN_SPEC
    stream = torch.cuda.current_stream(device).cuda_stream
    out = {}
    for label, B, need_dx in (("hidden-stencil", 4300, True),
                              ("layer0-rows", 100, False),
                              ("layer0-columns", 21, False)):
        gen = torch.Generator().manual_seed(4000)
        cores = [c.to(device) for c in tt.tt_init(gen, spec)]
        x = torch.randn((B, spec.in_dim), generator=gen).to(device)
        dy = torch.randn((B, spec.out_dim), generator=gen).to(device)
        dx = torch.empty_like(x)
        desc = ttc._descriptor(cores, spec)
        row = {"rows": B}
        for name, path in libs.items():
            per_sm, (saved, rows) = THIS_LAYOUT[name]
            if B < 1000:
                saved, rows = spec.L, 1
            tiles = -(-B // rows)
            blocks = min(tiles, per_sm * ttc.H100_SMS)
            groups = ttc.grad_groups(blocks)[1]
            grad = torch.empty(spec.num_params, device=device)
            partials = torch.empty((blocks + groups) * spec.num_params,
                                   device=device)
            tickets = torch.zeros(groups + 1, dtype=torch.int32,
                                  device=device)
            fn = ctypes.CDLL(str(path)).tt_contract_grad_launch
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call():
                err = fn(x.data_ptr(), dy.data_ptr(),
                         dx.data_ptr() if need_dx else None,
                         partials.data_ptr(), grad.data_ptr(),
                         tickets.data_ptr(), desc.ctypes.data, B, rows,
                         saved, blocks, stream)
                if err:
                    raise RuntimeError(f"{name} {label}: CUDA error {err}")

            trace = chip_smoke._profile(
                call, 5, match="tt_contract_grad_kernel",
                lead=lambda: torch.zeros(1, device=device))
            row[name] = {"saved": saved, "rows_a_tile": rows,
                         "blocks": blocks,
                         "alone_ms": None if trace["match_ms"] is None
                         else trace["match_ms"] / trace["match_kernels"]}
        out[label] = row
        print(f"[tt-grad-ablation] {label} {json.dumps(row)}", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("tt_grad_ablation: needs a CUDA device and PARENT_SRC or "
              "--this", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    import repro_torch
    from repro_torch.kernels import _build
    _, _, card = chip_smoke.phase_device()
    device = repro_torch.resolve_device("cuda")
    if sys.argv[1] == "--this":
        libs = build(ROOT / "src", THIS_VARIANTS, _build.NVCC_FLAGS,
                     _build.find_nvcc())
        out = measure_this(libs, device, chip_smoke)
    else:
        libs = build(Path(sys.argv[1]).resolve(), VARIANTS,
                     _build.NVCC_FLAGS, _build.find_nvcc())
        out = measure(libs, device, chip_smoke)
    print(f"[tt-grad-ablation] {json.dumps(out)}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
