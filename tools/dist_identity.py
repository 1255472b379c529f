#!/usr/bin/env python3
"""Whether a rank's slice of the stacked FD stencil keeps the whole stack's
bits, and what the stacked head costs.

A rank of ``repro_torch.parallel.zo_shard`` evaluates a slice of the
stacked models (entries of the padded stack) on a shard of the batch; the
single-rank fused step evaluates all N+1 entries on the whole batch.  The
FD residual amplifies any difference in u between the two by 1/h², so the
distributed gradient equals the single-rank one only if every row's u
keeps its bits when P and B change.  For each case this script evaluates
the model's own ``fd_u_stencil_stacked`` (tonn, ``fd_fast``) on the whole
stack and on each half of it (the entries of a ``2x1`` layout's ranks) and
of the batch (a ``1x2`` layout's points), and reports whether each half's
u is bit-equal to the same rows of the whole.  Then it times the model's
stacked head (``TensorPinn._f_head_stacked``, with the hidden layer's
chain replaced by a fixed product so that only the head's own operations
run) at the paper's shapes: hjb-20d's 11 x 4300 rows and
black-scholes-100d's 11 x 20,300, hidden 1024, on CUDA events.

    python3 tools/dist_identity.py [SRC]          # on the card
    python3 tools/dist_identity.py --device cpu   # a rehearsal on the CPU

``SRC`` is the ``src`` directory of the checkout whose ``repro_torch`` is
loaded (default: this checkout's); to compare two heads, run parent,
change, change, parent, each a process, in one call.  Prints one JSON line
a case and ``[dist-identity]`` summaries, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (pde, hidden, batch, N): the benchmark's identity rows' width, and on the
# card the paper's config
CASES = [(p, 32, 64, 6) for p in ("hjb-10d", "heat-10d", "black-scholes-8d-rs",
                                  "hjb-20d", "heat-10d-kappa", "hjb-10d-lam")]
PAPER_CASE = ("hjb-20d", 1024, 100, 10)
# (P, rows, hidden) of the stacked head: hjb-20d's and black-scholes-100d's
HEAD_SHAPES = ((11, 4300, 1024), (11, 20300, 1024))


def _identity(torch, pinn, zoo, counter_generator, dev, pde, hidden, batch,
              n) -> dict:
    model = pinn.TensorPinn(pinn.PINNConfig(
        hidden=hidden, mode="tonn", tt_L=3, pde=pde, deriv="fd_fast",
        use_fused_kernel=True))
    params = zoo.tree_map(lambda t: t.to(dev),
                          model.init(counter_generator(0)))
    xt = model.problem.sample_collocation(counter_generator(0, 1),
                                          batch).to(dev)
    xis = zoo.sample_perturbations(counter_generator(2, device=dev), params,
                                   n, model.trainable_mask(params))
    stacked = zoo.perturbed_stack(params, xis,
                                  zoo.SPSAConfig(num_samples=n))

    def u(lo, hi, pts):
        part = zoo.tree_map(lambda t: t[lo:hi], stacked)
        return model.fd_u_stencil_stacked(
            model.prepare_params_stacked(part, None), pts, model.fd_step)

    whole = u(0, n + 1, xt)
    per, half = -(-(n + 1) // 2), batch // 2
    halves = {"pert": [((0, per), whole[:per], u(0, per, xt)),
                       ((per, n + 1), whole[per:], u(per, n + 1, xt))],
              "batch": [((0, half), whole[:, :, :half],
                         u(0, n + 1, xt[:half])),
                        ((half, batch), whole[:, :, half:],
                         u(0, n + 1, xt[half:]))]}
    return {kind: [{"rows": list(span), "bit_equal": bool(torch.equal(got,
                                                                      want)),
                    "max_abs": float((got - want).abs().max())}
                   for span, want, got in rows]
            for kind, rows in halves.items()}


def _time(torch, fn, iters=20) -> float:
    for _ in range(3):
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _head_ms(torch, pinn, counter_generator, dev, P, rows, hidden) -> float:
    """ms of one ``_f_head_stacked`` call on (P, rows, hidden) activations,
    the hidden layer's product fixed."""
    model = pinn.TensorPinn(pinn.PINNConfig(
        hidden=hidden, mode="tonn", tt_L=3, pde="hjb-20d", deriv="fd_fast",
        use_fused_kernel=True))
    g = counter_generator(3, device=dev)
    z = torch.randn(P, rows, hidden, generator=g, device=dev)
    model._layer_matvec_stacked = lambda *args, **kw: z
    stacked = {"b1": torch.randn(P, hidden, generator=g, device=dev),
               "w2": torch.randn(P, 1, hidden, generator=g, device=dev),
               "b2": torch.randn(P, 1, generator=g, device=dev)}
    f = model._f_head_stacked(stacked, None)
    assert f.shape == (P, rows) and bool(torch.isfinite(f).all()), f.shape
    return _time(torch, lambda: model._f_head_stacked(stacked, None))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to load")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)
    import torch
    from repro_torch.core import pinn, zoo
    from repro_torch.device import counter_generator, resolve_device
    assert pinn.__file__.startswith(src), pinn.__file__
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = None
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    cases = CASES + [PAPER_CASE] if dev.type == "cuda" else CASES
    shapes = HEAD_SHAPES if dev.type == "cuda" else ((11, 430, 64),)
    with torch.no_grad():
        for pde, hidden, batch, n in cases:
            row = _identity(torch, pinn, zoo, counter_generator, dev, pde,
                            hidden, batch, n)
            print(json.dumps({"src": src, "pde": pde, "hidden": hidden,
                              "batch": batch, "n": n, "card": card, **row}),
                  flush=True)
            parts = {k: all(r["bit_equal"] for r in v)
                     for k, v in row.items()}
            print(f"[dist-identity] {pde} hidden {hidden}: halves bit-equal "
                  f"to the whole stack — perturbation {parts['pert']}, "
                  f"batch {parts['batch']}", flush=True)
        times = {f"{P}x{rows}x{hidden}": _head_ms(
                     torch, pinn, counter_generator, dev, P, rows, hidden)
                 for P, rows, hidden in shapes}
    print(f"[dist-identity] head ms ({src}) on {card or 'the CPU'}: "
          f"{json.dumps(times)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
