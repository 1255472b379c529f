"""ns-2d three-term training on the PyTorch port: the composite loss-term
engine end to end.  The port of ``benchmarks/ns_data.py`` (its two arms,
its config, its four gates and its keys).

The 2-D Navier–Stokes workload carries all three term kinds (collocation
residual, soft initial condition ``ic``, a data fit to noisy ω*
observations), rides the ``Domain`` normalization and the per-axis
periodic spectral estimator.  Two ZO-signSGD arms, the same budget, at the
reference's config (tt, hidden 32, ``tt_L`` 2, ``deriv="auto"``, batch 16,
N = 10, lr 3e-2 halved every epochs/3, μ 0.02, 600 epochs):

  * ``full``: all three terms, from the counter-keyed term stream;
  * ``no_data``: the data term's batch withheld every step (the same
    collocation and ic batches otherwise).

The four gates of the reference, each reported as measured with its bound
and a verdict (``--ci`` exits non-zero where one fails; no bound differs
from the reference's):

  * val-MSE floor: the full arm's val MSE against the Taylor–Green ω* on
    2,000 points below ``VAL_MSE_GATE``;
  * data-term ablation: ``no_data``'s val MSE ≥ ``ABLATION_GATE`` × the
    full arm's;
  * periodic-spectral path: both arms resolve ``auto`` to the spectral
    estimator with the ("periodic", "periodic", "window") periodization,
    and the engine's loss equals a loss assembled by hand from the line
    rows (rows → forward → per-axis FFT → Jacobian → residual), bit for
    bit;
  * legacy loss parity: on every registered problem with no ``Domain`` and
    no feature map the engine's loss equals ``L_r + λ·L_b`` assembled by
    hand from the ``fd_fast`` stencil, bit for bit; on ns-2d (no
    pre-engine semantics: the port has no ``bc=``) it equals the weighted
    sum of its terms assembled by hand.

Beside the port's numbers the record carries the reference's own, read
from ``BENCH_ns_data.json`` (the JAX package on a CPU, its threefry draws:
other batches than the port's), and each arm's loss every ``LOG_EVERY``
epochs.  Random draws come from ``device.counter_generator``: params from
``(seed)``, epoch i's collocation batch from ``(seed, i, 0)``, the term
batches from the term stream at ``seed``, ξ from ``(seed + 1, i)``, the
validation points from ``(1234)``.

    PYTHONPATH=src python benchmarks/torch_ns_data.py --out ns_data.json

appends one record a call to ``--out`` (required), with the card's name
and power limit; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
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
from repro_torch import pde  # noqa: E402
from repro_torch.core import pinn, spectral, zoo  # noqa: E402
from repro_torch.data import pde_term_batch_iterator  # noqa: E402
from repro_torch.device import (counter_generator, resolve_device,  # noqa: E402
                                to_device)

VAL_MSE_GATE = 5e-2     # the reference's: full-arm val MSE floor
ABLATION_GATE = 2.0     # the reference's: no_data val MSE ≥ 2× the full's
LOG_EVERY = 50
REFERENCE_JSON = ROOT / "BENCH_ns_data.json"


def _make_model(hidden: int) -> pinn.TensorPinn:
    return pinn.TensorPinn(pinn.PINNConfig(hidden=hidden, mode="tt",
                                           tt_rank=2, tt_L=2, deriv="auto",
                                           pde="ns-2d"))


def train_arm(ablate_data: bool, hidden: int, epochs: int, batch: int,
              num_samples: int, lr: float, mu: float, seed: int,
              dev: torch.device, log_every: int = LOG_EVERY,
              xi_device: torch.device | None = None) -> dict:
    """One arm; with ``xi_device`` each step's ξ is drawn there (as a run
    on that device draws it) and moved to ``dev``."""
    t0 = time.perf_counter()
    model = _make_model(hidden)
    problem = model.problem
    params = to_device(model.init(counter_generator(seed)), dev)
    mask = model.trainable_mask(params)
    scfg = zoo.SPSAConfig(num_samples=num_samples, mu=mu)
    state = zoo.ZOState(step=0, seed=seed + 1)

    def step(params, state, xt, tb, lr_t):
        xis = None
        if xi_device is not None:
            xis = to_device(zoo.sample_perturbations(
                counter_generator(state.seed, state.step, device=xi_device),
                to_device(params, xi_device), num_samples, mask), dev)
        return zoo.zo_signsgd_step(
            params, state, lr_t, scfg,
            batched_loss_fn=lambda sp: pinn.residual_losses_stacked(
                model, sp, xt, term_batches=tb),
            trainable_mask=mask,
            loss_fn=lambda p: pinn.residual_loss(model, p, xt,
                                                 term_batches=tb), xis=xis)

    terms = pde_term_batch_iterator(batch, seed=seed, problem=problem)
    losses, launches = [], None
    with torch.no_grad():
        for i in range(epochs):
            xt = problem.sample_collocation(counter_generator(seed, i, 0),
                                            batch).to(dev)
            tb = to_device(next(terms), dev)
            if ablate_data:
                del tb["data"]   # the same keys and batches otherwise
            lr_t = lr * 0.5 ** (i / max(epochs // 3, 1))
            if i == 1 and dev.type == "cuda":
                kernel_launches(reset=True)
            params, state, loss = step(params, state, xt, tb, lr_t)
            if i == 1 and dev.type == "cuda":
                torch.cuda.synchronize()
                launches = {k: v for k, v in kernel_launches().items() if v}
            if i % log_every == 0 or i == epochs - 1:
                losses.append([i, float(loss)])
        val = problem.sample_collocation(counter_generator(1234),
                                         2000).to(dev)
        val_mse = float(pinn.validation_mse(model, params, val))
    return {"val_mse": val_mse,
            "resolved_deriv": pinn._resolve_deriv(model.cfg, problem),
            "seconds": time.perf_counter() - t0,
            "ms_per_step": 1e3 * (time.perf_counter() - t0) / max(epochs, 1),
            "launches_per_step": launches, "losses": losses,
            "_model": model, "_params": params}


def check_spectral_path(model: pinn.TensorPinn, params: dict,
                        dev: torch.device, seed: int = 0) -> dict:
    """The arm's loss is the periodic spectral path: the engine's loss
    equals one assembled by hand from the line rows, bit for bit."""
    problem = model.problem
    with torch.no_grad():
        prepared, _ = model.prepare_params(params, None)
        xt = problem.sample_collocation(counter_generator(seed, 5),
                                        32).to(dev)
        M = problem.spectral_points
        rows = spectral.spectral_line_rows(xt, model.in_dim, M,
                                           problem.spectral_extent)
        est = spectral.estimate_from_line_vals(
            model.u(prepared, rows), xt, model.in_dim, M,
            problem.spectral_extent, problem.spectral_periodization,
            carrier=problem.spectral_carrier(rows, xt))
        r = problem.residual(problem.scale_estimate(est), xt)
        manual = torch.mean(r * r)
        engine = pinn.residual_loss(model, params, xt)
    return {"resolved_deriv": pinn._resolve_deriv(model.cfg, problem),
            "periodization": list(problem.spectral_periodization),
            "loss_bit_identical_to_line_assembly": bool(
                torch.equal(manual, engine)),
            "inferences_per_loss": spectral.num_spectral_inferences(
                32, model.in_dim, M)}


def check_legacy_parity(dev: torch.device, batch: int = 8,
                        seed: int = 0) -> dict:
    """Over the registry: the term engine's loss against the loss
    assembled by hand, bit for bit (``L_r + λ·L_b`` from the ``fd_fast``
    stencil where the problem has pre-engine semantics; the weighted sum
    of every term on ns-2d)."""
    out = {}
    with torch.no_grad():
        for name in pde.available():
            model = pinn.TensorPinn(pinn.PINNConfig(
                hidden=16, mode="tt", tt_rank=2, tt_L=2, deriv="fd_fast",
                pde=name))
            prob = model.problem
            params = to_device(model.init(counter_generator(seed)), dev)
            prepared, noise = model.prepare_params(params, None)
            b = 4 if prob.space_dim >= 100 else batch
            xt = prob.sample_collocation(counter_generator(seed, 1),
                                         b).to(dev)
            tb = {t.name: to_device(t.sample(counter_generator(seed, 2, i),
                                             b), dev)
                  for i, t in enumerate(prob.loss_terms())
                  if t.kind != "collocation"}
            engine = pinn.residual_loss(model, params, xt, term_batches=tb)
            if (prob.domain is not None and not prob.domain.is_unit) \
                    or prob.has_feature_map:
                per = pinn.per_term_losses(model, params, xt,
                                           term_batches=tb)
                weights = prob.term_weights()
                manual = weights["residual"] * per["residual"] \
                    if weights["residual"] != 1.0 else per["residual"]
                for k in tb:
                    manual = manual + weights[k] * per[k]
            else:
                vals = model.fd_u_stencil(prepared, xt, model.fd_step, noise)
                est = pde.estimate_from_u_stencil(vals, model.fd_step)
                r = prob.residual(est, xt)
                manual = torch.mean(r * r)
                if "boundary" in tb:
                    xb, ub = tb["boundary"]
                    manual = manual + prob.bc_weight * torch.mean(
                        (model.u(prepared, xb, noise) - ub) ** 2)
            out[name] = bool(torch.equal(manual, engine))
    return out


def reference_numbers() -> dict | None:
    """The reference's own run of the same config (the JAX package on a
    CPU), from ``BENCH_ns_data.json``."""
    if not REFERENCE_JSON.exists():
        return None
    with open(REFERENCE_JSON) as f:
        ref = json.load(f)
    return {"source": REFERENCE_JSON.name, "config": ref["config"],
            "val_mse": {k: v["val_mse"] for k, v in ref["arms"].items()},
            "ablation_ratio": ref["ablation_ratio"],
            "spectral_path": ref["spectral_path"],
            "legacy_parity_all": all(ref["legacy_parity"].values())}


def gates(result: dict) -> dict:
    """Each gate as measured: value, bound and verdict."""
    full = result["arms"]["full"]
    sp = result["spectral_path"]
    derivs = [sp["resolved_deriv"]] + [a["resolved_deriv"]
                                       for a in result["arms"].values()]
    legacy = result["legacy_parity"]
    return {
        "val_mse_floor": {"value": full["val_mse"], "bound": VAL_MSE_GATE,
                          "passed": full["val_mse"] < VAL_MSE_GATE},
        "data_ablation": {"value": result["ablation_ratio"],
                          "bound": ABLATION_GATE,
                          "passed": result["ablation_ratio"]
                          >= ABLATION_GATE},
        "periodic_spectral_path": {
            "value": {"resolved": derivs,
                      "periodization": sp["periodization"],
                      "bit_identical": sp[
                          "loss_bit_identical_to_line_assembly"]},
            "bound": "spectral, [periodic, periodic, window], bit-identical",
            "passed": (set(derivs) == {"spectral"}
                       and sp["periodization"] == ["periodic", "periodic",
                                                   "window"]
                       and sp["loss_bit_identical_to_line_assembly"])},
        "legacy_loss_parity": {
            "value": sorted(k for k, v in legacy.items() if not v),
            "bound": "no problem off", "passed": all(legacy.values())},
    }


def run(hidden: int = 32, epochs: int = 600, batch: int = 16,
        num_samples: int = 10, lr: float = 3e-2, mu: float = 0.02,
        seed: int = 0, device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    arms = {name: train_arm(ablate, hidden, epochs, batch, num_samples, lr,
                            mu, seed, dev)
            for name, ablate in (("full", False), ("no_data", True))}
    spectral_path = check_spectral_path(arms["full"].pop("_model"),
                                        arms["full"].pop("_params"), dev,
                                        seed)
    arms["no_data"].pop("_model"), arms["no_data"].pop("_params")
    full, ab = arms["full"]["val_mse"], arms["no_data"]["val_mse"]
    result = {
        "config": {"pde": "ns-2d", "mode": "tt", "hidden": hidden,
                   "tt_L": 2, "deriv": "auto", "epochs": epochs,
                   "batch": batch, "num_samples": num_samples, "lr": lr,
                   "mu": mu, "seed": seed, "val_mse_gate": VAL_MSE_GATE,
                   "ablation_gate": ABLATION_GATE,
                   "device": {"type": dev.type,
                              "kind": (torch.cuda.get_device_name(dev)
                                       if cuda else None),
                              "nvidia_smi": card_line() if cuda else None},
                   "torch": torch.__version__},
        "arms": arms,
        "ablation_ratio": ab / max(full, 1e-12),
        "spectral_path": spectral_path,
        "legacy_parity": check_legacy_parity(dev, seed=seed),
        "reference": reference_numbers(),
    }
    result["gates"] = gates(result)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="ns-2d three-term training "
                                             "on the port")
    ap.add_argument("--ci", action="store_true",
                    help="exit non-zero where a gate fails")
    ap.add_argument("--out", required=True,
                    help="the JSON file this call's record is appended to "
                         "(under \"runs\")")
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--num-samples", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--mu", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU only cpu runs")
    args = ap.parse_args(argv)
    result = run(hidden=args.hidden, epochs=args.epochs, batch=args.batch,
                 num_samples=args.num_samples, lr=args.lr, mu=args.mu,
                 seed=args.seed, device=args.device)
    doc = {"runs": []}
    if os.path.exists(args.out):
        with open(args.out) as f:
            doc = json.load(f)
    doc["runs"].append(result)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    full, nd = result["arms"]["full"], result["arms"]["no_data"]
    print(f"[ns-2d] full: val_mse={full['val_mse']:.4e} "
          f"({full['seconds']:.1f}s, {full['ms_per_step']:.3f} ms a step) | "
          f"no_data: val_mse={nd['val_mse']:.4e} | ablation "
          f"{result['ablation_ratio']:.3f}x", flush=True)
    for name, g in result["gates"].items():
        print(f"[gate] {name}: {g['value']} against {g['bound']}: "
              f"{'passed' if g['passed'] else 'FAILED'}")
    failed = [n for n, g in result["gates"].items() if not g["passed"]]
    if args.ci and failed:
        raise SystemExit(f"gates failed: {failed}")
    return result


if __name__ == "__main__":
    main()
