"""One full ZO-signSGD step on the PyTorch port: the fused stacked step
against the naive sequential one.  The port of ``benchmarks/zo_step.py``
(``bench_mode`` and ``run``, the same arms and the same row keys).

Arms per PINN mode, at the paper's config by default (hidden 1024, batch
100, N = 10, ``tt_rank`` 2, ``tt_L`` 4) on a registered problem
(``--pde``, default hjb-20d):

  * ``naive_seed``: the generic FD stencil (``deriv="fd"``: 2·in_dim+1
    rows a point through the whole network) and the N+1 loss evaluations
    one model at a time (``zoo.zo_signsgd_step`` without
    ``batched_loss_fn``); on the card each evaluation runs one grouped
    densification (tonn) and two ``tt_contract`` launches;
  * ``fused``: the incremental FD stencil (``fd_fast``) and all N+1
    models in one stacked program (``residual_losses_stacked``): one
    grouped densification and three ``tt_contract_batched`` launches, two
    more for a boundary term.

A problem with a boundary loss (helmholtz-2d) steps on the trainer's
``max(batch // 4, 8)`` boundary rows in both arms (the reference passes
its step no boundary batch).  Both arms are timed from the same params
and state, interleaved (naive, fused, naive, ...) ``--repeats`` times,
each time over ``--iters`` back-to-back steps after warm-ups, on CUDA
events (``chip_smoke._time_ms``; ``--device cpu``: the host clock), and
the median kept.  Each arm's kernel launches of one step are counted on
the card.  Parity for identical ξ goes through
``torch_pde_suite.parity_check``, the single home of that contract; the
script exits non-zero where it fails.

    PYTHONPATH=src python benchmarks/torch_zo_step.py --pde hjb-20d \\
        --out zo_step.json

appends one record a call to ``--out`` (required), with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # invoked as `python benchmarks/...`
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the CUDA-event timer)
from benchmarks.torch_pde_suite import parity_check  # noqa: E402
from benchmarks.torch_table1_hjb import card_line, kernel_launches  # noqa: E402
from repro_torch import pde as pde_lib  # noqa: E402
from repro_torch.core import pinn, zoo  # noqa: E402
from repro_torch.data import pde_term_batch_iterator  # noqa: E402
from repro_torch.device import (counter_generator, resolve_device,  # noqa: E402
                                to_device)


def _make_step(model, scfg, xt, tb, batched: bool, mask):
    """One ZO step of ``model`` from given params and state: fused through
    the stacked losses, or sequential through ``residual_loss``."""
    def step(params, state):
        return zoo.zo_signsgd_step(
            params, state, 1e-3, scfg,
            batched_loss_fn=(lambda sp: pinn.residual_losses_stacked(
                model, sp, xt, term_batches=tb)) if batched else None,
            trainable_mask=mask,
            loss_fn=lambda p: pinn.residual_loss(model, p, xt,
                                                 term_batches=tb))
    return step


def _launches(fn, cuda: bool) -> dict | None:
    """The counted kernels one call of ``fn`` launches (those it launches
    at all), or None off the card."""
    if not cuda:
        return None
    kernel_launches(reset=True)
    fn()
    torch.cuda.synchronize()
    return {k: v for k, v in kernel_launches().items() if v}


def _time_pair(fn_a, fn_b, repeats: int, iters: int, host: bool) -> tuple:
    """Median ms per call of two arms, timed in turn ``repeats`` times so
    that drift hits both."""
    ta, tb = [], []
    for _ in range(repeats):
        ta.append(chip_smoke._time_ms(fn_a, iters, warmup=2, host=host))
        tb.append(chip_smoke._time_ms(fn_b, iters, warmup=2, host=host))
    return statistics.median(ta), statistics.median(tb)


def bench_mode(mode: str, hidden: int, batch: int, num_samples: int,
               tt_rank: int, tt_L: int, repeats: int, seed: int = 0,
               pde: str = "hjb-20d", device: str | torch.device = "cuda",
               iters: int = 10) -> dict:
    """One row: both arms' ms a step, the speedup, each arm's launches a
    step and the parity of the stacked and sequential losses."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    base = pinn.PINNConfig(hidden=hidden, mode=mode, tt_rank=tt_rank,
                           tt_L=tt_L, pde=pde)
    naive_model = pinn.TensorPinn(dataclasses.replace(
        base, deriv="fd", use_fused_kernel=False))
    fused_model = pinn.TensorPinn(dataclasses.replace(
        base, deriv="fd_fast", use_fused_kernel=True))
    problem = naive_model.problem
    scfg = zoo.SPSAConfig(num_samples=num_samples, mu=0.01)
    xt = problem.sample_collocation(counter_generator(seed, 1),
                                    batch).to(dev)
    tb = to_device(next(pde_term_batch_iterator(
        max(batch // 4, 8), seed=seed, problem=problem)), dev) or None
    params = to_device(naive_model.init(counter_generator(seed)), dev)
    state = zoo.ZOState(step=0, seed=seed + 1)
    # one mask for both arms: the same ξ on the trainable leaves, the
    # photonic ±1 diags untouched by either
    mask = naive_model.trainable_mask(params)
    naive = _make_step(naive_model, scfg, xt, tb, False, mask)
    fused = _make_step(fused_model, scfg, xt, tb, True, mask)
    with torch.no_grad():
        naive_ms, fused_ms = _time_pair(lambda: naive(params, state),
                                        lambda: fused(params, state),
                                        repeats, iters, host=not cuda)
        launches = {"naive_seed": _launches(lambda: naive(params, state),
                                            cuda),
                    "fused": _launches(lambda: fused(params, state), cuda)}
    parity = parity_check(pde, hidden=hidden, batch=batch,
                          num_samples=num_samples, tt_rank=tt_rank,
                          tt_L=tt_L, seed=seed, mode=mode, device=dev)
    return {
        "mode": mode,
        "pde": pde,
        "naive_seed_ms": naive_ms,
        "fused_ms": fused_ms,
        "speedup": naive_ms / fused_ms,
        **parity,
        "launches_per_step": launches,
    }


def run(hidden: int = 1024, batch: int = 100, num_samples: int = 10,
        tt_rank: int = 2, tt_L: int = 4, repeats: int = 3,
        modes: tuple = ("tonn", "tt"), pde: str = "hjb-20d",
        device: str | torch.device = "cuda", iters: int = 10) -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    rows = []
    for m in modes:
        rows.append(bench_mode(m, hidden, batch, num_samples, tt_rank, tt_L,
                               repeats, pde=pde, device=dev, iters=iters))
        print(json.dumps(rows[-1]), flush=True)
    return {
        "config": {"hidden": hidden, "batch": batch,
                   "num_samples": num_samples, "tt_rank": tt_rank,
                   "tt_L": tt_L, "pde": pde,
                   "space_dim": pde_lib.get_problem(pde).space_dim,
                   "repeats": repeats, "iters": iters,
                   "device": {"type": dev.type,
                              "kind": (torch.cuda.get_device_name(dev)
                                       if cuda else None),
                              "nvidia_smi": card_line() if cuda else None},
                   "torch": torch.__version__},
        "rows": rows,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="ZO step on the port: fused "
                                             "against naive")
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--num-samples", type=int, default=10)
    ap.add_argument("--tt-rank", type=int, default=2)
    ap.add_argument("--tt-L", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10,
                    help="back-to-back steps per timed repeat")
    ap.add_argument("--modes", default="tonn,tt")
    ap.add_argument("--pde", default="hjb-20d",
                    help="registered PDE workload (repro_torch.pde)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU only cpu runs")
    ap.add_argument("--out", required=True,
                    help="the JSON file this call's record is appended to "
                         "(under \"runs\")")
    args = ap.parse_args(argv)

    result = run(hidden=args.hidden, batch=args.batch,
                 num_samples=args.num_samples, tt_rank=args.tt_rank,
                 tt_L=args.tt_L, repeats=args.repeats,
                 modes=tuple(args.modes.split(",")), pde=args.pde,
                 device=args.device, iters=args.iters)
    doc = {"runs": []}
    if os.path.exists(args.out):
        with open(args.out) as f:
            doc = json.load(f)
    doc["runs"].append(result)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    bad = [r for r in result["rows"] if not r["losses_agree"]]
    if bad:
        raise SystemExit(f"fused/naive divergence: {bad}")
    return result


if __name__ == "__main__":
    main()
