"""Multi-PDE workload suite on the PyTorch port: every registered problem of
``repro_torch.pde`` through the stacked BP-free solver stack.  The port of
``benchmarks/pde_suite.py`` (``parity_check``, ``run_problem`` and ``run``,
the same checks and the same JSON keys).

Per problem, two checks:

  * **parity**: for identical SPSA perturbations ξ the stacked evaluator
    (``pinn.residual_losses_stacked``: one densification of every
    perturbed mesh, the stacked TT chain ``tt_contract_batched`` on the
    card, the shared FD stencil) must match the sequential per-model sweep
    (``residual_loss`` one model at a time, ``tt_contract`` on the card):
    stencil u-values to 1e-4 of max|u| (the f32 forward; the bound
    ``chip_smoke._u_close`` holds the card to the CPU with), the loss
    vectors to 1e-1 of the largest loss (the 1/h² FD amplification of f32
    rounding, DESIGN.md §Perf), the boundary term included where the
    problem has one.  The reference's per-element figure,
    max|Δu| / (|u| + 1e-6), is recorded as ``u_max_rel_err`` but decides
    nothing: where u crosses zero, as helmholtz-2d's u = f does (no
    ansatz offset), it divides an f32 rounding of the head's sum by ~1e-6
    (on the card at hidden 1024: 3e-4–6e-4 where max|Δu| / max|u| is
    ~1e-7).  ``parity_check`` is the single home of that contract
    in the port: ``benchmarks/torch_zo_step.py`` checks through it too.
  * **train**: a short on-chip ZO-signSGD run
    (``torch_table1_hjb.run_row("tt", on_chip=True, noise=False)``) must
    end with a finite loss.

Writes ``--out`` (required) and exits non-zero on a parity failure or a
non-finite loss.  ``--ci`` applies ``CI_SIZES``, the reference's
per-problem budgets.

    PYTHONPATH=src python benchmarks/torch_pde_suite.py --hidden 1024 \\
        --batch 100 --epochs 60 --out pde_suite.json

runs every problem at the paper's width on the card (the default device;
``--device cpu`` runs the plain versions, at toy widths only).  Random
draws come from ``device.counter_generator``: params ``(seed)``, the
collocation rows ``(seed, 1)``, ξ ``(seed, 2)``, the boundary rows
``(seed, 3)``; so the JAX suite's rows and ξ are not these.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import torch

try:
    from benchmarks.torch_table1_hjb import card_line, run_row
except ImportError:  # invoked as `python benchmarks/torch_pde_suite.py`
    from torch_table1_hjb import card_line, run_row
from repro_torch import pde as pde_lib
from repro_torch.core import pinn, zoo
from repro_torch.device import counter_generator, resolve_device, to_device

# per-problem budgets --ci applies (the 100-dim problem pays 201 stencil
# rows a point, so it gets a smaller batch); flags set by hand win
CI_SIZES = {
    "black-scholes-100d": {"batch": 8, "epochs": 30},
}

U_RTOL = 1e-4           # stencil u-values, of max|u| (the f32 forward)
LOSS_RTOL = 1e-1        # loss vectors, of the largest loss (the FD floor)


def parity_check(pde: str, hidden: int, batch: int, num_samples: int = 6,
                 tt_rank: int = 2, tt_L: int = 3, seed: int = 0,
                 mode: str = "tt",
                 device: str | torch.device = "cuda") -> dict:
    """Stacked against sequential evaluation for identical ξ on one
    problem: ``{"u_max_rel_err", "u_max_err_over_max_u",
    "loss_max_rel_err", "losses_agree"}``."""
    dev = resolve_device(device)
    base = pinn.PINNConfig(hidden=hidden, mode=mode, tt_rank=tt_rank,
                           tt_L=tt_L, pde=pde, deriv="fd_fast")
    fused = pinn.TensorPinn(dataclasses.replace(base, use_fused_kernel=True))
    check = pinn.TensorPinn(base)
    problem = fused.problem

    xt = problem.sample_collocation(counter_generator(seed, 1), batch).to(dev)
    tb = ({"boundary": to_device(problem.boundary_batch(
        counter_generator(seed, 3), batch), dev)}
          if problem.has_boundary_loss else None)
    params = to_device(check.init(counter_generator(seed)), dev)
    scfg = zoo.SPSAConfig(num_samples=num_samples, mu=0.01)
    xis = zoo.sample_perturbations(counter_generator(seed, 2, device=dev),
                                   params, num_samples)
    sp = zoo.tree_map(lambda p, z: p + scfg.mu * z, params, xis)
    models = [zoo.tree_map(lambda t: t[i], sp) for i in range(num_samples)]

    with torch.no_grad():
        # stencil u-values: the f32 forward's tolerance
        u_fused = fused.fd_u_stencil_stacked(
            fused.prepare_params_stacked(sp, None), xt, fused.fd_step)
        u_seq = torch.stack([check.fd_u_stencil(p, xt, check.fd_step)
                             for p in models])
        du = torch.abs(u_fused - u_seq)
        u_rel = float(torch.max(du / (torch.abs(u_seq) + 1e-6)))
        u_err = float(torch.max(du) / torch.max(torch.abs(u_seq)))
        # the loss vectors: the FD floor
        l_seq = torch.stack([pinn.residual_loss(check, p, xt,
                                                term_batches=tb)
                             for p in models])
        l_fused = pinn.residual_losses_stacked(fused, sp, xt,
                                               term_batches=tb)
        loss_rel = float(torch.max(torch.abs(l_fused - l_seq))
                         / (float(torch.max(torch.abs(l_seq))) + 1e-12))
    return {
        "u_max_rel_err": u_rel,
        "u_max_err_over_max_u": u_err,
        "loss_max_rel_err": loss_rel,
        "losses_agree": bool(u_err < U_RTOL and loss_rel < LOSS_RTOL),
    }


def run_problem(pde: str, hidden: int, batch: int, epochs: int,
                num_samples: int = 6, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """Parity in ``tt`` (the digital TT baseline) and ``tonn`` (the mesh
    per core, densified per perturbation), then a short on-chip run."""
    t0 = time.time()
    parity = {mode: parity_check(pde, hidden=hidden, batch=batch,
                                 num_samples=num_samples, seed=seed,
                                 mode=mode, device=device)
              for mode in ("tt", "tonn")}
    row = run_row("tt", on_chip=True, noise=False, hidden=hidden,
                  epochs=epochs, batch=batch, seed=seed, pde=pde,
                  device=device)
    problem = pde_lib.get_problem(pde)
    return {
        "pde": pde,
        "in_dim": problem.in_dim,
        "has_boundary_loss": problem.has_boundary_loss,
        "has_exact_solution": problem.has_exact_solution,
        "parity": parity,
        "final_loss": row["final_loss"],
        "val_mse": row["val_mse_ideal"],
        "params": row["params"],
        "seconds": round(time.time() - t0, 1),
    }


def run(pdes=None, hidden: int = 32, batch: int = 16, epochs: int = 60,
        num_samples: int = 6, ci: bool = False,
        explicit: frozenset = frozenset(),
        device: str | torch.device = "cuda") -> dict:
    """Every problem of ``pdes`` (default: all registered).  ``ci`` applies
    ``CI_SIZES``, except to the knobs named in ``explicit``."""
    dev = resolve_device(device)
    pdes = tuple(pde_lib.available() if pdes is None else pdes)
    rows, budgets = [], {}
    for pde in pdes:
        budget = {"hidden": hidden, "batch": batch, "epochs": epochs}
        if ci:
            budget.update({k: v for k, v in CI_SIZES.get(pde, {}).items()
                           if k not in explicit})
        budgets[pde] = budget
        rows.append(run_problem(pde, num_samples=num_samples, device=dev,
                                **budget))
        print(json.dumps(rows[-1]), flush=True)
    cuda = dev.type == "cuda"
    return {
        "config": {"ci": ci, "hidden": hidden, "batch": batch,
                   "epochs": epochs, "num_samples": num_samples,
                   "budgets": budgets, "pdes": list(pdes),
                   "device": {"type": dev.type,
                              "kind": (torch.cuda.get_device_name(dev)
                                       if cuda else None),
                              "nvidia_smi": card_line() if cuda else None},
                   "torch": torch.__version__},
        "rows": rows,
    }


def failures(result: dict) -> list:
    """Every parity failure and non-finite loss of ``result``."""
    out = []
    for r in result["rows"]:
        for mode, p in r["parity"].items():
            if not p["losses_agree"]:
                out.append(f"stacked/sequential divergence on {r['pde']} "
                           f"[{mode}]: {p}")
        if not math.isfinite(r["final_loss"]):
            out.append(f"non-finite final loss on {r['pde']}: "
                       f"{r['final_loss']}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Multi-PDE suite on the port")
    ap.add_argument("--ci", action="store_true",
                    help="the reference's per-problem CI budgets")
    ap.add_argument("--pdes", default=",".join(pde_lib.available()),
                    help="comma-separated registry names")
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--num-samples", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU only cpu runs")
    ap.add_argument("--out", required=True, help="the JSON file written")
    args = ap.parse_args(argv)

    explicit = frozenset(k for k in ("hidden", "batch", "epochs")
                         if getattr(args, k) != ap.get_default(k))
    result = run(pdes=args.pdes.split(","), hidden=args.hidden,
                 batch=args.batch, epochs=args.epochs,
                 num_samples=args.num_samples, ci=args.ci, explicit=explicit,
                 device=args.device)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    bad = failures(result)
    if bad:
        raise SystemExit("; ".join(bad))
    print(f"[pde_suite] {len(result['rows'])} problems OK")
    return result


if __name__ == "__main__":
    main()
