#!/usr/bin/env python3
"""Rows per block of the TT fiber body, swept on one GPU.

    python3 tools/tt_fiber_rows.py

Launches ``tt_contract`` (B = 2048, the served pool, and 65,536) and
``tt_contract_batched_quant`` (int8 block 32, the hidden layer of a QAT
step: P = 11, 4300 rows per entry) at the paper's spec through their C
entries with each rows-per-block in ``ROWS``, beside the tile that
``fiber_tile`` picks.  Every tile must give the wrapper's bits (a row's
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


def sweep(device, chip_smoke) -> dict:
    import torch
    from repro_torch.core import tt
    from repro_torch.kernels import quant as quant_lib
    from repro_torch.kernels import tt_contract as ttc

    spec = tt.PAPER_TONN_SPEC
    single, _, quant_launch = ttc._launchers()
    stream = torch.cuda.current_stream(device).cuda_stream
    out = {}
    gen = torch.Generator().manual_seed(7)
    for batch in (2048, 65536):
        cores = [c.to(device) for c in tt.tt_init(gen, spec)]
        x = torch.randn((batch, spec.in_dim), generator=gen).to(device)
        want = ttc.tt_contract(x, cores, spec)
        desc = ttc._descriptor(cores, spec)
        row = {"tile": ttc.fiber_tile(spec, batch).rows}
        for rows in ROWS:
            y = torch.empty_like(want)

            def launch():
                err = single(x.data_ptr(), y.data_ptr(), desc.ctypes.data,
                             batch, rows, stream)
                if err:
                    raise RuntimeError(f"rows {rows}: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise AssertionError(f"tt_contract B={batch} at {rows} rows "
                                     "differs from the wrapper's tile")
            row[rows] = chip_smoke._time_ms(launch, 200 if batch < 4096
                                            else 50)
        out[f"tt_contract-B{batch}"] = row
    P, B = 11, 4300
    quant = quant_lib.QuantConfig(enabled=True, dtype="int8", block=32)
    per = [tt.tt_init(gen, spec) for _ in range(P)]
    cores = [torch.stack([c[k] for c in per]).to(device)
             for k in range(spec.L)]
    x = torch.randn((P, B, spec.in_dim), generator=gen).to(device)
    want = ttc.tt_contract_batched_quant(x, cores, spec, quant)
    codes, scales = zip(*(quant_lib.quantize_blockwise_stacked(c, quant)
                          for c in cores))
    desc = ttc._descriptor(codes, spec, scales)
    row = {"tile": ttc.fiber_tile(spec, P * B).rows}
    for rows in ROWS:
        y = torch.empty_like(want)

        def launch():
            err = quant_launch(x.data_ptr(), y.data_ptr(), desc.ctypes.data,
                               B, P, B * spec.in_dim, rows, quant.block, 0,
                               stream)
            if err:
                raise RuntimeError(f"rows {rows}: CUDA error {err}")

        launch()
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise AssertionError(f"tt_contract_batched_quant at {rows} rows "
                                 "differs from the wrapper's tile")
        row[rows] = chip_smoke._time_ms(launch, 50)
    out["tt_contract_batched_quant-hidden"] = row
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
