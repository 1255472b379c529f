"""Spectral against FD residual estimation on the PyTorch port: the BP-free
inference bill.  The port of ``benchmarks/residual_perf.py`` (its two
workloads, its two arms, its four gates and its row keys).

FD prices a loss evaluation at ``(2A+1)·B`` inferences (A differentiated
axes, B collocation points): 2,300 for the 10-dim workloads at batch 100.
The spectral estimator prices it at ``B·(A·(M−1)+1)`` for an M-point line
grid an axis: 702 at batch 9 and M = 8.  Two arms a workload (heat-10d,
hjb-10d), the same ZO-signSGD budget, at the paper's model by default
(tonn, hidden 1024, ``PAPER_TONN_SPEC``, noise on, N = 10):

  * ``fd``: the incremental FD stencil (``fd_fast``), fused, batch 100 (3
    ``tt_contract_batched`` launches a loss evaluation on the card);
  * ``spectral``: the line rows through the same fused stacked forward (2
    launches), windowed periodization with the problem's carrier, batch 9
    at M = 8.

The four gates of the reference, each reported as measured with its bound
and a verdict (``--ci`` exits non-zero where one fails; no bound differs
from the reference's):

  * inference bill: spectral spends ≥ 3× fewer inferences a loss;
  * matched accuracy: spectral's val MSE (1,000 exact-solution points)
    ≤ 1.1× the fd arm's after the same number of ZO steps;
  * wall clock: a ZO step of each arm, timed in turns (``--repeats``
    medians of ``--iters`` back-to-back steps on CUDA events; ``--device
    cpu``: the host clock); spectral no slower than fd;
  * fd/stein off the path: ``deriv="auto"`` on a problem that says "fd"
    gives the fd losses bit for bit (one model and stacked), a set
    ``spectral_points`` leaves ``fd_fast`` bit for bit, and Stein by
    ``auto`` equals Stein named, on the same directions.

Random draws come from ``device.counter_generator``: params and chip from
``(seed)`` and ``(seed, 99)``, epoch i's batch from ``(seed, i, 0)``, ξ
from ``(seed + 1, i)``, the validation points from ``(1234)``.

    PYTHONPATH=src python benchmarks/torch_residual_perf.py \\
        --out residual_perf.json

appends one record a call to ``--out`` (required), with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # invoked as `python benchmarks/...`
    sys.path.insert(0, str(ROOT))

from benchmarks.torch_table1_hjb import card_line, kernel_launches  # noqa: E402
from benchmarks.torch_zo_step import _time_pair  # noqa: E402
from repro_torch.configs.hjb_pinn import pinn_config  # noqa: E402
from repro_torch.core import pinn, spectral, stein, zoo  # noqa: E402
from repro_torch.device import (counter_generator, resolve_device,  # noqa: E402
                                to_device)
from repro_torch.pde.heat import HeatProblem  # noqa: E402

WORKLOADS = ("heat-10d", "hjb-10d")
INFERENCE_RATIO_GATE = 3.0   # spectral spends ≥ 3× fewer inferences a loss
MSE_RATIO_GATE = 1.1         # ... at ≤ 1.1× the fd arm's val MSE
STEP_SPEEDUP_GATE = 1.0      # ... and its ZO step is no slower

# arm -> (deriv, batch, spectral_points): 9·(11·7+1) = 702 inferences a
# loss against fd's 23·100 = 2,300 on the 11-axis workloads (3.28×)
ARMS = {
    "fd": {"deriv": "fd_fast", "batch": 100, "spectral_points": None},
    "spectral": {"deriv": "spectral", "batch": 9, "spectral_points": 8},
}


def _inferences_per_loss(deriv: str, batch: int, n_active: int,
                         points: int | None) -> int:
    if deriv == "spectral":
        return spectral.num_spectral_inferences(batch, n_active, points)
    return stein.num_fd_inferences(n_active) * batch


def _config(pde: str, model_kw: dict, **overrides) -> pinn.PINNConfig:
    """The paper's on-chip model (tonn, noise on, fused) at ``model_kw``'s
    width."""
    return pinn_config(pde=pde, mode="tonn", noise=True, **model_kw,
                       **overrides)


def _make_step(model, scfg, mask, noise):
    def step(params, state, xt, lr_t):
        return zoo.zo_signsgd_step(
            params, state, lr_t, scfg,
            batched_loss_fn=lambda sp: pinn.residual_losses_stacked(
                model, sp, xt, noise),
            trainable_mask=mask,
            loss_fn=lambda p: pinn.residual_loss(model, p, xt, noise))
    return step


def train_arm(pde: str, arm: dict, model_kw: dict, epochs: int,
              num_samples: int, lr: float, seed: int,
              dev: torch.device) -> dict:
    """One on-chip ZO-signSGD run of an arm (the reference's budget: lr
    halved every epochs/3) → its final val MSE, inference bill, seconds,
    kernel launches a step, and a timed step on a fixed batch."""
    t0 = time.perf_counter()
    model = pinn.TensorPinn(_config(pde, model_kw, deriv=arm["deriv"],
                                    spectral_points=arm["spectral_points"]))
    problem = model.problem
    params = to_device(model.init(counter_generator(seed)), dev)
    noise = model.sample_noise(counter_generator(seed, 99))
    noise = None if noise is None else to_device(noise, dev)
    mask = model.trainable_mask(params)
    scfg = zoo.SPSAConfig(num_samples=num_samples, mu=0.01)
    state = zoo.ZOState(step=0, seed=seed + 1)
    step = _make_step(model, scfg, mask, noise)
    with torch.no_grad():
        for i in range(epochs):
            xt = problem.sample_collocation(counter_generator(seed, i, 0),
                                            arm["batch"]).to(dev)
            lr_t = lr * 0.5 ** (i / max(epochs // 3, 1))
            params, state, _ = step(params, state, xt, lr_t)
        val = problem.sample_collocation(counter_generator(1234),
                                         1000).to(dev)
        val_mse = float(pinn.validation_mse(model, params, val, noise))
        xt_fix = problem.sample_collocation(
            counter_generator(seed, 10_001, 0), arm["batch"]).to(dev)
        launches = None
        if dev.type == "cuda":
            kernel_launches(reset=True)
            step(params, state, xt_fix, lr)
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernel_launches().items() if v}
    return {
        "val_mse": val_mse,
        "inferences_per_loss": _inferences_per_loss(
            arm["deriv"], arm["batch"], model.in_dim,
            arm["spectral_points"]),
        "seconds": time.perf_counter() - t0,
        "launches_per_step": launches,
        "_timed": lambda: step(params, state, xt_fix, lr)[2],
    }


def bench_workload(pde: str, model_kw: dict, epochs: int, num_samples: int,
                   lr: float, repeats: int, iters: int, seed: int,
                   dev: torch.device) -> dict:
    res = {name: train_arm(pde, arm, model_kw, epochs, num_samples, lr,
                           seed, dev) for name, arm in ARMS.items()}
    fd_fn, sp_fn = res["fd"].pop("_timed"), res["spectral"].pop("_timed")
    with torch.no_grad():
        fd_ms, sp_ms = _time_pair(fd_fn, sp_fn, repeats, iters,
                                  host=dev.type != "cuda")
    res["fd"]["zo_step_ms"] = fd_ms
    res["spectral"]["zo_step_ms"] = sp_ms
    fd, sp = res["fd"], res["spectral"]
    return {
        "pde": pde,
        **{f"{n}_{k}": v for n, r in res.items() for k, v in r.items()},
        "inference_ratio": fd["inferences_per_loss"]
        / sp["inferences_per_loss"],
        "mse_ratio": sp["val_mse"] / max(fd["val_mse"], 1e-12),
        "step_speedup": fd_ms / sp_ms,
    }


def check_off_path(model_kw: dict, dev: torch.device, batch: int = 16,
                   seed: int = 0) -> dict:
    """Bit-identity of the fd and Stein paths through the estimator
    dispatch: "auto" resolution and an inert ``spectral_points``."""
    base = _config("heat-10d", model_kw, deriv="fd")
    m_fd = pinn.TensorPinn(base)
    params = to_device(m_fd.init(counter_generator(seed)), dev)
    noise = m_fd.sample_noise(counter_generator(seed, 99))
    noise = None if noise is None else to_device(noise, dev)
    xt = m_fd.problem.sample_collocation(counter_generator(seed, 1),
                                         batch).to(dev)
    sp = zoo.tree_map(lambda t: torch.stack([t, 1.01 * t, 0.99 * t]),
                      params)

    def same(m_a, m_b, **kw):
        return (torch.equal(pinn.residual_loss(m_a, params, xt, noise, **kw),
                            pinn.residual_loss(m_b, params, xt, noise, **kw))
                and torch.equal(
                    pinn.residual_losses_stacked(m_a, sp, xt, noise, **kw),
                    pinn.residual_losses_stacked(m_b, sp, xt, noise, **kw)))

    def model(problem=None, **kw):
        return pinn.TensorPinn(dataclasses.replace(base, **kw), problem)

    with torch.no_grad():
        fd_auto = same(m_fd, model(deriv="auto"))
        fast_inert = same(model(deriv="fd_fast"),
                          model(deriv="fd_fast", spectral_points=8))
        p_stein = HeatProblem(space_dim=10)
        p_stein.estimator = "stein"
        m_stein = model(deriv="stein", stein_samples=8)
        z = stein.stein_directions(xt, counter_generator(seed, 2, device=dev),
                                   8, m_stein.in_dim)
        zs = stein.stein_directions(xt, counter_generator(seed, 3,
                                                          device=dev),
                                    8, m_stein.in_dim, lead=(3,))
        m_auto = model(p_stein, deriv="auto", stein_samples=8)
        stein_auto = (
            torch.equal(pinn.residual_loss(m_stein, params, xt, noise, z=z),
                        pinn.residual_loss(m_auto, params, xt, noise, z=z))
            and torch.equal(
                pinn.residual_losses_stacked(m_stein, sp, xt, noise, z=zs),
                pinn.residual_losses_stacked(m_auto, sp, xt, noise, z=zs)))
    return {"fd_auto_bit_identical": fd_auto,
            "fd_fast_spectral_points_inert": fast_inert,
            "stein_auto_bit_identical": stein_auto}


def gates(result: dict) -> dict:
    """Each gate as measured: value, bound and verdict (a workload's own
    where it has one)."""
    out = {}
    for r in result["rows"]:
        for name, value, bound, ok in (
                ("inference_ratio", r["inference_ratio"],
                 INFERENCE_RATIO_GATE,
                 r["inference_ratio"] >= INFERENCE_RATIO_GATE),
                ("mse_ratio", r["mse_ratio"], MSE_RATIO_GATE,
                 r["mse_ratio"] <= MSE_RATIO_GATE),
                ("step_speedup", r["step_speedup"], STEP_SPEEDUP_GATE,
                 r["step_speedup"] >= STEP_SPEEDUP_GATE)):
            out[f"{r['pde']}/{name}"] = {"value": value, "bound": bound,
                                         "passed": bool(ok)}
    off = result["off_path"]
    out["off_path"] = {"value": off, "bound": "all bit-identical",
                       "passed": all(off.values())}
    return out


def run(pdes=WORKLOADS, hidden: int = 1024, tt_L: int = 4,
        epochs: int = 300, num_samples: int = 10, lr: float = 2e-3,
        repeats: int = 5, iters: int = 10, seed: int = 0,
        device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    model_kw = {"hidden": hidden, "tt_L": tt_L}
    rows = []
    for p in pdes:
        rows.append(bench_workload(p, model_kw, epochs, num_samples, lr,
                                   repeats, iters, seed, dev))
        print(json.dumps(rows[-1]), flush=True)
    result = {
        "config": {"pdes": list(pdes), **model_kw, "tt_rank": 2,
                   "mode": "tonn", "noise": True, "epochs": epochs,
                   "num_samples": num_samples, "lr": lr, "seed": seed,
                   "repeats": repeats, "iters": iters,
                   "arms": {n: dict(a) for n, a in ARMS.items()},
                   "inference_ratio_gate": INFERENCE_RATIO_GATE,
                   "mse_ratio_gate": MSE_RATIO_GATE,
                   "step_speedup_gate": STEP_SPEEDUP_GATE,
                   "device": {"type": dev.type,
                              "kind": (torch.cuda.get_device_name(dev)
                                       if cuda else None),
                              "nvidia_smi": card_line() if cuda else None},
                   "torch": torch.__version__},
        "rows": rows,
        "off_path": check_off_path(model_kw, dev, seed=seed),
    }
    result["gates"] = gates(result)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="spectral against FD residual "
                                             "estimation on the port")
    ap.add_argument("--ci", action="store_true",
                    help="exit non-zero where a gate fails")
    ap.add_argument("--out", required=True,
                    help="the JSON file this call's record is appended to "
                         "(under \"runs\")")
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--tt-L", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--num-samples", type=int, default=10)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pdes", default=None,
                    help=f"comma-separated subset of {list(WORKLOADS)}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU only cpu runs")
    args = ap.parse_args(argv)
    result = run(pdes=tuple(args.pdes.split(",")) if args.pdes else WORKLOADS,
                 hidden=args.hidden, tt_L=args.tt_L, epochs=args.epochs, num_samples=args.num_samples,
                 lr=args.lr, repeats=args.repeats, iters=args.iters,
                 seed=args.seed, device=args.device)
    doc = {"runs": []}
    if os.path.exists(args.out):
        with open(args.out) as f:
            doc = json.load(f)
    doc["runs"].append(result)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    for name, g in result["gates"].items():
        print(f"[gate] {name}: {g['value']} against {g['bound']}: "
              f"{'passed' if g['passed'] else 'FAILED'}")
    failed = [n for n, g in result["gates"].items() if not g["passed"]]
    if args.ci and failed:
        raise SystemExit(f"gates failed: {failed}")
    return result


if __name__ == "__main__":
    main()
