#!/usr/bin/env python3
"""Rows per block of the TT fiber body, swept on one GPU.

    python3 tools/tt_fiber_rows.py

Launches the three TT entries at the paper's spec through their C entries
with each rows-per-block of a sweep, beside the tile that ``fiber_tile``
picks: ``tt_contract`` (B = 2048, the served pool, and 65,536),
``tt_contract_batched`` at the three launches of a ZO step (P = 11: layer 0
on the 21 identity columns and on the 100 rows, x shared, and the hidden
layer's 4300 rows per entry) and ``tt_contract_batched_quant`` (int8 block
32) at the hidden layer.  Every tile must give the wrapper's bits (a row's
value does not depend on its tile); each is timed on CUDA events over
back-to-back launches.  Prints one ``[fiber-rows]`` JSON line and the
card's name and power limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = (4, 8, 12, 16, 24, 32)
SMALL_ROWS = (1, 2, 3, 4, 8)           # layer 0: a few rows per entry


def _sweep(chip_smoke, name: str, launch, want, rows_set, tile: int,
           iters: int) -> dict:
    """Time ``launch(rows, y)`` at each rows-per-block, after checking
    that it gives ``want``'s bits."""
    import torch
    row = {"tile": tile}
    for rows in rows_set:
        y = torch.empty_like(want)

        def run():
            err = launch(rows, y)
            if err:
                raise RuntimeError(f"{name} at {rows} rows: CUDA error {err}")

        run()
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise AssertionError(f"{name} at {rows} rows differs from the "
                                 "wrapper's tile")
        row[rows] = chip_smoke._time_ms(run, iters)
    return row


def sweep(device, chip_smoke) -> dict:
    import torch
    from repro_torch.core import tt
    from repro_torch.kernels import quant as quant_lib
    from repro_torch.kernels import tt_contract as ttc

    spec = tt.PAPER_TONN_SPEC
    single, batched, quant_launch, _ = ttc._launchers()
    stream = torch.cuda.current_stream(device).cuda_stream
    out = {}
    gen = torch.Generator().manual_seed(7)
    for batch in (2048, 65536):
        cores = [c.to(device) for c in tt.tt_init(gen, spec)]
        x = torch.randn((batch, spec.in_dim), generator=gen).to(device)
        desc = ttc._descriptor(cores, spec)
        out[f"tt_contract-B{batch}"] = _sweep(
            chip_smoke, "tt_contract",
            lambda rows, y: single(x.data_ptr(), y.data_ptr(),
                                   desc.ctypes.data, batch, rows, stream),
            ttc.tt_contract(x, cores, spec), ROWS,
            ttc.fiber_tile(spec, batch).rows, 200 if batch < 4096 else 50)
    P = 11
    quant = quant_lib.QuantConfig(enabled=True, dtype="int8", block=32)
    for label, B, shared, rows_set in (
            ("layer0-columns", 21, True, SMALL_ROWS),
            ("layer0-rows", 100, True, SMALL_ROWS + (16,)),
            ("hidden", 4300, False, ROWS)):
        per = [tt.tt_init(gen, spec) for _ in range(P)]
        cores = [torch.stack([c[k] for c in per]).to(device)
                 for k in range(spec.L)]
        x = torch.randn((B, spec.in_dim) if shared
                        else (P, B, spec.in_dim), generator=gen).to(device)
        desc = ttc._descriptor(cores, spec)
        stride = 0 if shared else B * spec.in_dim
        tile = ttc.fiber_tile(spec, P * B).rows
        out[f"tt_contract_batched-{label}"] = _sweep(
            chip_smoke, "tt_contract_batched",
            lambda rows, y: batched(x.data_ptr(), y.data_ptr(),
                                    desc.ctypes.data, B, P, stride, rows,
                                    stream),
            ttc.tt_contract_batched(x, cores, spec), rows_set, tile, 50)
        if label == "hidden":
            out["tt_contract_batched_quant-hidden"] = _sweep(
                chip_smoke, "tt_contract_batched_quant",
                lambda rows, y: quant_launch(
                    x.data_ptr(), y.data_ptr(), desc.ctypes.data, B, P,
                    stride, rows, quant.block, ttc.CODE_TYPES[quant.dtype],
                    stream),
                ttc.tt_contract_batched_quant(x, cores, spec, quant),
                rows_set, tile, 50)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tt_fiber_rows: no CUDA device; this script runs on the GPU "
              "only", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    import repro_torch
    _, _, card = chip_smoke.phase_device()
    out = sweep(repro_torch.resolve_device("cuda"), chip_smoke)
    print(f"[fiber-rows] {json.dumps(out)}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
