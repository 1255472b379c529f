"""Coefficient-conditioned families against dedicated per-coefficient
models on the PyTorch port.  The port of ``benchmarks/coeff_family.py``
(its three families, budgets, held-out coefficients, floors and gates),
plus a ``--zo`` arm at the paper's width.

For each family (heat-10d-kappa, hjb-10d-lam, black-scholes-8d-rs) it
trains ONE conditioned model over the coefficient range and, per held-out
coefficient, a DEDICATED model pinned to it at the same budget: BP AdamW
(lr 3e-3), tt at hidden 48, ``tt_L`` 3, batch 128, FD derivatives; on the
card each TT layer runs ``tt_contract`` forward and ``tt_contract_grad``
backward.  Then the closed-form validation MSE of both on 400 points.

The reference's four gates, each reported as measured with its bound and a
verdict (``--ci`` exits non-zero where one fails):

  * family accuracy: on each held-out coefficient the family model's val
    MSE ≤ max(``RATIO`` × the dedicated model's, the family's floor);
  * conditioning bites: at both range ends the family model evaluated
    with the true coefficient beats itself evaluated with the opposite
    end, against the true solution;
  * f32 fixed-coefficient off-path: the unconditioned path bit for bit
    through the seams that conditioning generalized (a default against an
    explicit κ = 1 heat problem, on the ``fd_fast`` stencil and the
    stacked losses; ``shared_x=None`` against ``True`` in
    ``tt_linear_batched``; ``n_active=None`` against ``in_dim`` in the FD
    estimator);
  * serving: one ``c1``-tagged program serves every coefficient instance
    of heat-10d-kappa with zero rebuilds after the first, each request
    within an f32 ulp of the direct forward on its augmented rows (the
    reference asks for bit identity, which its own engine misses by an
    ulp on a CPU; the port holds both packages' served u to one ulp).

``--zo`` adds black-scholes-100d-rs at the paper's config (tonn, hidden
1024, ``PAPER_TONN_SPEC``, noise on, ``fd_fast``, N = 10, batch 100, C = 4
coefficient draws a step) trained by ZO-signSGD for ``ZO_STEPS``: its
val MSE at each held-out (r, σ) against the closed form before and after
training, and ms a ZO step
(CUDA events, median of 3 × 10 steps).

Random draws come from ``device.counter_generator``: params from
``(seed)``, step i's batch from the collocation stream at ``seed``, heat's
boundary rows from ``(seed + 5, i)``, the validation points from ``(7)``.

    PYTHONPATH=src python benchmarks/torch_coeff_family.py --out cf.json

appends one record a call to ``--out`` (required), with the card's name
and power limit; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # invoked as `python benchmarks/...`
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the CUDA-event timer)
from benchmarks.torch_table1_hjb import card_line, kernel_launches  # noqa: E402
from repro_torch import pde as pde_lib  # noqa: E402
from repro_torch.configs.hjb_pinn import pinn_config  # noqa: E402
from repro_torch.core import pinn, stein, tt, zoo  # noqa: E402
from repro_torch.data import pde_collocation_iterator  # noqa: E402
from repro_torch.device import (counter_generator, resolve_device,  # noqa: E402
                                to_device)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.pde.black_scholes import BlackScholesProblem  # noqa: E402
from repro_torch.pde.heat import HeatProblem  # noqa: E402
from repro_torch.pde.hjb import HJBProblem  # noqa: E402

# family -> (registered conditioned pde, training steps, accuracy floor,
#            held-out coefficient vectors, dedicated-problem factory)
FAMILIES = {
    "heat": ("heat-10d-kappa", 800, 2.5e-2,
             ((0.6,), (1.1,), (1.8,)),
             lambda c: HeatProblem(space_dim=10, kappa=c[0])),
    "hjb": ("hjb-10d-lam", 400, 1e-2,
            ((0.06,), (0.10,), (0.14,)),
            lambda c: HJBProblem(space_dim=10, lam=c[0])),
    "black-scholes": ("black-scholes-8d-rs", 400, 5e-3,
                      ((0.02, 0.25), (0.05, 0.40), (0.09, 0.55)),
                      lambda c: BlackScholesProblem(space_dim=8, r=c[0],
                                                    sigma=c[1])),
}
RATIO = 2.0
ZO_PDE = "black-scholes-100d-rs"
ZO_HELD_OUT = ((0.02, 0.25), (0.05, 0.40), (0.09, 0.55))
ZO_STEPS = 300          # the --zo arm's fixed budget


def train_cell(problem, steps: int, dev: torch.device, hidden: int = 48,
               batch: int = 128, lr: float = 3e-3, seed: int = 0):
    """One BP AdamW run on an explicit problem instance (the family or a
    dedicated pin): the budget both arms of the comparison get."""
    cfg = pinn.PINNConfig(hidden=hidden, mode="tt", tt_rank=2, tt_L=3,
                          pde=problem.name)
    model = pinn.TensorPinn(cfg, problem=problem)
    params = to_device(model.init(counter_generator(seed)), dev)
    opt = get_optimizer("adamw", lr=lr)
    state = opt.init(params)
    step = train._bp_step_fn(model, opt, model.trainable_mask(params), None)
    colloc = pde_collocation_iterator(batch, seed=seed, problem=problem)
    for i in range(steps):
        tb = ({"boundary": to_device(problem.boundary_batch(
            counter_generator(seed + 5, i), 32), dev)}
              if problem.has_boundary_loss else {})
        params, state, _ = step(params, state, next(colloc).to(dev), tb)
    return model, params


def _val_mse(model, params, pts, coeffs=None) -> float:
    prob = model.problem
    xt = prob.attach_coeffs(pts, coeffs) if coeffs is not None else pts
    with torch.no_grad():
        return float(pinn.validation_mse(model, params, xt))


def run_family(family: str, dev: torch.device, hidden: int = 48,
               seed: int = 0, steps: int | None = None) -> dict:
    pde, budget, floor, held_out, dedicated = FAMILIES[family]
    steps = budget if steps is None else steps
    t0 = time.perf_counter()
    kernel_launches(reset=True)
    fam_model, fam_params = train_cell(pde_lib.get_problem(pde), steps, dev,
                                       hidden=hidden, seed=seed)
    launches = ({k: v for k, v in kernel_launches().items() if v}
                if dev.type == "cuda" else None)
    fam_prob = fam_model.problem
    pts = fam_prob.sample_collocation(counter_generator(7),
                                      400)[:, :fam_prob.in_dim].to(dev)
    rows = []
    for c in held_out:
        dm, dp = train_cell(dedicated(c), steps, dev, hidden=hidden,
                            seed=seed)
        fam_mse = _val_mse(fam_model, fam_params, pts, c)
        ded_mse = _val_mse(dm, dp, pts)
        rows.append({"coeffs": list(c), "family_val_mse": fam_mse,
                     "dedicated_val_mse": ded_mse,
                     "ratio": fam_mse / max(ded_mse, 1e-12),
                     "gate_bound": max(RATIO * ded_mse, floor)})
    bites = []
    for c, other in ((held_out[0], held_out[-1]),
                     (held_out[-1], held_out[0])):
        exact = fam_prob.exact_solution(fam_prob.attach_coeffs(pts, c))
        with torch.no_grad():
            u_wrong = fam_model.u(fam_params,
                                  fam_prob.attach_coeffs(pts, other))
        bites.append({"coeffs": list(c),
                      "true_coeff_mse": _val_mse(fam_model, fam_params, pts,
                                                 c),
                      "wrong_coeff_mse": float(torch.mean(
                          (u_wrong - exact) ** 2))})
    return {"pde": pde, "steps": steps, "floor": floor,
            "coeff_spec": fam_prob.coeff_spec.to_meta(), "held_out": rows,
            "conditioning_bites": bites,
            "family_launches": launches,
            "seconds": time.perf_counter() - t0}


def check_f32_off_path(dev: torch.device, batch: int = 16,
                       seed: int = 0) -> dict:
    """Bit identity of the unconditioned path through every seam that
    conditioning generalized."""
    cfg = pinn.PINNConfig(hidden=32, mode="tt", tt_rank=2, tt_L=3,
                          pde="heat-10d", deriv="fd_fast")
    m0 = pinn.TensorPinn(cfg, problem=HeatProblem(space_dim=10))
    m1 = pinn.TensorPinn(cfg, problem=HeatProblem(space_dim=10, kappa=1.0))
    params = to_device(m0.init(counter_generator(seed)), dev)
    xt = m0.problem.sample_collocation(counter_generator(seed, 1),
                                       batch).to(dev)
    sp = zoo.tree_map(lambda t: torch.stack([t, 1.01 * t, 0.99 * t]),
                      params)
    spec = tt.auto_factorize(32, 32, L=3, max_rank=2)
    gen = counter_generator(seed, 2)
    stacks = [torch.stack([c[k] for c in (tt.tt_init(gen, spec)
                                          for _ in range(3))]).to(dev)
              for k in range(spec.L)]
    x = torch.randn((batch, 32), generator=counter_generator(seed, 3)).to(dev)
    f = lambda pts: m0.u(params, pts)
    with torch.no_grad():
        u0 = m0.fd_u_stencil(params, xt, m0.fd_step)
        u1 = m1.fd_u_stencil(params, xt, m1.fd_step)
        l0 = pinn.residual_losses_stacked(m0, sp, xt)
        l1 = pinn.residual_losses_stacked(m1, sp, xt)
        y_none = ops.tt_linear_batched(x, stacks, spec)
        y_true = ops.tt_linear_batched(x, stacks, spec, shared_x=True)
        e_none = stein.fd_estimate(f, xt, h=m0.fd_step)
        e_in = stein.fd_estimate(f, xt, h=m0.fd_step,
                                 n_active=m0.problem.in_dim)
    return {"stencil_bit_identical": bool(torch.equal(u0, u1)),
            "losses_bit_identical": bool(torch.equal(l0, l1)),
            "shared_x_bit_identical": bool(torch.equal(y_none, y_true)),
            "n_active_bit_identical": bool(
                torch.equal(e_none.hess_diag, e_in.hess_diag)
                and torch.equal(e_none.grad, e_in.grad))}


def _max_ulps(got, want) -> float:
    want32 = np.asarray(want, np.float32)
    return float((np.abs(np.asarray(got, np.float64) - want32)
                  / np.spacing(np.abs(want32))).max())


def check_serving(dev: torch.device, hidden: int = 32, seed: int = 0) -> dict:
    """One conditioned program serves the family: 3 instances, each within
    an ulp of the direct forward on its augmented rows, then 4 fresh
    instances with no rebuild."""
    from repro_torch.serving import (PdeServingEngine, PointRequest,
                                     SolverRegistry)
    reg = SolverRegistry(device=dev)
    s = reg.register_fresh("fam", pinn.PINNConfig(
        hidden=hidden, mode="tt", tt_rank=2, tt_L=3, pde="heat-10d-kappa"),
        seed=seed, device=dev)
    eng = PdeServingEngine(reg, slots=2, slot_points=32, enable_cache=False,
                           device=dev)
    pts = s.problem.sample_collocation(counter_generator(seed + 7),
                                       40)[:, :s.in_dim]
    ulps = []
    for k in (0.6, 1.0, 1.9):
        r = eng.submit(PointRequest("fam", pts.numpy(), coeffs=[k]))
        eng.run()
        with torch.no_grad():
            direct = s.model.u(s.params, s.problem.attach_coeffs(
                pts, [k]).to(dev)).cpu().numpy()
        ulps.append(_max_ulps(r.out, direct))
    compiles = eng.stats["compiles"]
    for k in (0.55, 0.77, 1.23, 1.88):
        eng.submit(PointRequest("fam", pts.numpy(), coeffs=[k]))
        eng.run()
    return {"family_max_ulps": max(ulps),
            "family_bit_identical": max(ulps) == 0.0,
            "programs": eng.serving_stats()["programs"],
            "compiles": compiles,
            "steady_state_recompiles": eng.stats["compiles"] - compiles}


def run_zo(dev: torch.device, steps: int = ZO_STEPS, seed: int = 0,
           coeffs_per_step: int = 4, batch: int = 100,
           num_samples: int = 10, lr: float = 2e-3,
           hidden: int = 1024) -> dict:
    """black-scholes-100d-rs at the paper's config by ZO-signSGD with C
    coefficient draws a step (the trainer's schedule: lr halved every
    steps/3): val MSE per held-out (r, σ) on 1,000 points, ms a step."""
    t0 = time.perf_counter()
    model = pinn.TensorPinn(pinn_config(pde=ZO_PDE, mode="tonn", noise=True,
                                        hidden=hidden))
    problem = model.problem
    params = to_device(model.init(counter_generator(seed)), dev)
    noise = to_device(model.sample_noise(counter_generator(seed, 99)), dev)
    mask = model.trainable_mask(params)
    scfg = zoo.SPSAConfig(num_samples=num_samples, mu=0.01)
    state = zoo.ZOState(step=0, seed=seed + 1)

    def step(params, state, xt, lr_t):
        return zoo.zo_signsgd_step(
            params, state, lr_t, scfg,
            batched_loss_fn=lambda sp: pinn.residual_losses_stacked(
                model, sp, xt, noise),
            trainable_mask=mask,
            loss_fn=lambda p: pinn.residual_loss(model, p, xt, noise))

    colloc = pde_collocation_iterator(batch, seed=seed, problem=problem,
                                      coeffs_per_step=coeffs_per_step)
    pts = problem.sample_collocation(counter_generator(1234),
                                     1000)[:, :problem.in_dim].to(dev)
    losses = []

    def val_rows():
        with torch.no_grad():
            return [_val_mse(model, params, pts, c) for c in ZO_HELD_OUT]

    initial = val_rows()
    launches = None
    with torch.no_grad():
        for i in range(steps):
            xt = next(colloc).to(dev)
            if i == 1 and dev.type == "cuda":
                kernel_launches(reset=True)
            params, state, loss = step(params, state, xt,
                                       lr * 0.5 ** (i / max(steps // 3, 1)))
            if i == 1 and dev.type == "cuda":
                torch.cuda.synchronize()
                launches = {k: v for k, v in kernel_launches().items() if v}
            losses.append(float(loss))
        final = val_rows()
        xt = next(colloc).to(dev)
        ms = [chip_smoke._time_ms(lambda: step(params, state, xt, lr)[2], 10,
                                  warmup=2, host=dev.type != "cuda")
              for _ in range(3)]
    return {"pde": ZO_PDE, "hidden": model.cfg.hidden, "mode": "tonn",
            "noise": True, "deriv": model.cfg.deriv, "steps": steps,
            "batch": batch, "zo_samples": num_samples,
            "coeffs_per_step": coeffs_per_step, "lr": lr,
            "held_out": [{"coeffs": list(c), "val_mse_initial": a,
                          "val_mse": b}
                         for c, a, b in zip(ZO_HELD_OUT, initial, final)],
            "loss_first": losses[0], "loss_last": losses[-1],
            "loss_median_last10": statistics.median(losses[-10:]),
            "zo_step_ms": statistics.median(ms), "zo_step_ms_runs": ms,
            "launches_per_step": launches,
            "seconds": time.perf_counter() - t0}


def gates(result: dict) -> dict:
    """Each gate as measured: value, bound and verdict."""
    out = {}
    for fam, r in result["families"].items():
        for row in r["held_out"]:
            cs = ",".join(f"{c:g}" for c in row["coeffs"])
            out[f"{fam}/{cs}/family_accuracy"] = {
                "value": row["family_val_mse"], "bound": row["gate_bound"],
                "passed": row["family_val_mse"] <= row["gate_bound"]}
        for b in r["conditioning_bites"]:
            cs = ",".join(f"{c:g}" for c in b["coeffs"])
            out[f"{fam}/{cs}/conditioning_bites"] = {
                "value": b["true_coeff_mse"], "bound": b["wrong_coeff_mse"],
                "passed": b["true_coeff_mse"] < b["wrong_coeff_mse"]}
    off = result["f32_off_path"]
    out["f32_off_path"] = {"value": off, "bound": "all bit-identical",
                           "passed": all(off.values())}
    srv = result["serving"]
    out["serving"] = {
        "value": {"programs": srv["programs"],
                  "steady_state_recompiles": srv["steady_state_recompiles"],
                  "family_max_ulps": srv["family_max_ulps"]},
        "bound": "one |c1| program, 0 recompiles, <= 1 ulp",
        "passed": (len(srv["programs"]) == 1
                   and "|c1|" in srv["programs"][0]
                   and srv["steady_state_recompiles"] == 0
                   and srv["family_max_ulps"] <= 1.0)}
    return out


def run(families=tuple(FAMILIES), hidden: int = 48, seed: int = 0,
        zo: bool = False, steps: int | None = None,
        device: str | torch.device = "cuda") -> dict:
    """Every family at ``steps`` BP steps (default: the reference's
    budgets), the off-path and serving checks, and with ``zo`` the ZO arm
    at ``ZO_STEPS``."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    result = {
        "config": {"families": list(families), "hidden": hidden,
                   "seed": seed, "ratio_gate": RATIO, "mode": "tt",
                   "steps": steps or "the reference's",
                   "tt_L": 3, "optimizer": "adamw", "lr": 3e-3,
                   "batch": 128,
                   "device": {"type": dev.type,
                              "kind": (torch.cuda.get_device_name(dev)
                                       if cuda else None),
                              "nvidia_smi": card_line() if cuda else None},
                   "torch": torch.__version__},
        "families": {},
    }
    for f in families:
        result["families"][f] = run_family(f, dev, hidden=hidden, seed=seed,
                                           steps=steps)
        print(json.dumps({f: result["families"][f]}), flush=True)
    result["f32_off_path"] = check_f32_off_path(dev, seed=seed)
    result["serving"] = check_serving(dev, seed=seed)
    if zo:
        result["zo"] = run_zo(dev, seed=seed)
        print(json.dumps({"zo": result["zo"]}), flush=True)
    result["gates"] = gates(result)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="conditioned families against "
                                             "dedicated models on the port")
    ap.add_argument("--ci", action="store_true",
                    help="exit non-zero where a gate fails")
    ap.add_argument("--out", required=True,
                    help="the JSON file this call's record is appended to "
                         "(under \"runs\")")
    ap.add_argument("--hidden", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--families", default=None,
                    help=f"comma-separated subset of {sorted(FAMILIES)}")
    ap.add_argument("--zo", action="store_true",
                    help=f"also train {ZO_PDE} at the paper's config by ZO "
                         f"for {ZO_STEPS} steps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU only cpu runs")
    args = ap.parse_args(argv)
    fams = (tuple(args.families.split(",")) if args.families
            else tuple(FAMILIES))
    result = run(families=fams, hidden=args.hidden, seed=args.seed,
                 zo=args.zo, device=args.device)
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
