"""PDE serving launcher: load trained solver checkpoints by name and drive
the slot-batched inference runtime (``repro_torch.serving``) on the GPU.

Each ``--ckpt NAME=DIR`` loads a self-describing checkpoint (the port's
and the JAX package's ``launch/train.py`` write them).  The port's trainer
saves a noise-enabled solver's chip noise in the checkpoint; one trained
by the JAX package with the noise model on also needs ``--hw-noise
NAME=FILE.npz``: its chip noise as ``/``-joined path keys
(``pcores0/1/u/gamma``, the ``arrays.npz`` format), because torch cannot
regenerate JAX's threefry draws from the seed.  ``--synthetic N`` then
serves N mixed variable-size requests; a coefficient-conditioned solver's
each carry one coefficient vector drawn in its trained ranges.

    PYTHONPATH=src python -m repro_torch.launch.serve_pde \\
        --ckpt heat=ckpts/heat-10d --ckpt hjb=ckpts/hjb-20d \\
        --hw-noise hjb=ckpts/hjb-20d-noise.npz --synthetic 64
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import interop
from repro_torch.serving import (PdeServingEngine, PointRequest,
                                 SolverRegistry, StencilCache)


def _name_value(spec: str, flag: str) -> tuple:
    name, _, value = spec.partition("=")
    if not name or not value:
        raise SystemExit(f"{flag} wants NAME=VALUE, got {spec!r}")
    return name, value


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", action="append", required=True,
                    metavar="NAME=DIR",
                    help="load checkpoint DIR as solver NAME (repeatable)")
    ap.add_argument("--hw-noise", action="append", default=[],
                    metavar="NAME=FILE",
                    help="chip-noise .npz of a noise-enabled solver "
                         "whose checkpoint carries none (JAX-trained)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--slot-points", type=int, default=256)
    ap.add_argument("--synthetic", type=int, default=32,
                    help="number of synthetic requests to serve")
    ap.add_argument("--max-request-points", type=int, default=256)
    ap.add_argument("--cache-capacity", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    noise_files = dict(_name_value(s, "--hw-noise") for s in args.hw_noise)
    reg = SolverRegistry(device=args.device)
    for spec in args.ckpt:
        name, directory = _name_value(spec, "--ckpt")
        hw_noise = None
        if name in noise_files:
            with np.load(noise_files.pop(name)) as data:
                hw_noise = interop.tree_from_flat(dict(data))
        s = reg.load_checkpoint(name, directory, hw_noise=hw_noise,
                                device=args.device)
        print(f"[serve_pde] loaded {name!r}: pde={s.problem.name} "
              f"mode={s.model.cfg.mode} step={s.step}")
    if noise_files:
        raise SystemExit(f"--hw-noise for unknown solver(s) "
                         f"{sorted(noise_files)}")

    engine = PdeServingEngine(reg, slots=args.slots,
                              slot_points=args.slot_points,
                              cache=StencilCache(args.cache_capacity),
                              device=args.device)
    engine.warmup()
    print(f"[serve_pde] warm: {engine.stats['compiles']} program(s), "
          f"pool {args.slots}x{args.slot_points} on {reg.device}")

    # pre-generate the traffic so measured latency is serving, not sampling
    rng = np.random.RandomState(args.seed)
    names = reg.names()
    traffic = []
    for i in range(args.synthetic):
        name = names[i % len(names)]
        n = int(rng.randint(1, args.max_request_points + 1))
        gen = torch.Generator().manual_seed(args.seed * 10_000 + i)
        problem = reg.get(name).problem
        rows = problem.sample_collocation(gen, n).numpy()
        coeffs = (None if problem.coeff_spec is None
                  else rows[0, problem.in_dim:])      # one scenario a request
        traffic.append((name, rows[:, :problem.in_dim], coeffs))
    t0 = time.perf_counter()
    reqs = [engine.submit(PointRequest(name, pts, coeffs=c))
            for name, pts, c in traffic]
    engine.run()
    wall = time.perf_counter() - t0

    lat_ms = np.asarray([r.latency_s for r in reqs]) * 1e3
    points = sum(len(r.points) for r in reqs)
    print(f"[serve_pde] served {len(reqs)} requests / {points} points in "
          f"{wall * 1e3:.2f} ms ({points / wall:.0f} pts/s): "
          f"p50 {np.percentile(lat_ms, 50):.2f} ms, "
          f"p99 {np.percentile(lat_ms, 99):.2f} ms")
    stats = engine.serving_stats()
    print(f"[serve_pde] programs: {stats['compiles']} built, "
          f"{stats['program_runs']} runs; stencil cache: "
          f"{stats['cache_hits']} hits / {stats['cache_misses']} misses, "
          f"{stats['cache_evictions']} evictions")
    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
