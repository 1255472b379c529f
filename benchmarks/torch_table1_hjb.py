"""Paper Table 1 on the PyTorch port: ONN vs TONN, off-chip vs on-chip (ZO)
training, with and without hardware noise — validation MSE against the
exact solution of a registered PDE workload (default: the paper's 20-dim
HJB).  The port of ``benchmarks/table1_hjb.py`` (``run_row`` and ``run``,
the same semantics and the same row names).

    PYTHONPATH=src python benchmarks/torch_table1_hjb.py \\
        --hidden 1024 --tt-L 4 --epochs 5000 --seeds 0 --out table1.json

runs the paper's five rows at its width and budget on the card (the
default device; ``--device cpu`` runs the plain versions).  Where the
kernels run on the card:

  * ``tt`` off-chip (and ``tonn`` off-chip, mapped onto the noisy chip):
    autograd of ``residual_loss`` through ``ops.tt_linear`` — the
    ``tt_contract`` kernel forward, ``tt_contract_grad`` backward; tonn's
    meshes densify in one grouped ``mesh_densify_stacked`` launch a step,
    and its backward ``mesh_densify_grad`` is one launch too;
  * ``tonn`` on-chip: ``residual_losses_stacked`` — one grouped
    ``mesh_densify_stacked`` and two ``tt_contract_batched`` launches a
    step;
  * ``onn`` on-chip: ``mesh_apply_stacked`` (its resident design and wide
    routes);
  * ``dense`` off-chip: ``torch.matmul`` and its autograd, no kernel of
    the port (the JAX package has none there either); ``dense`` mapped
    onto noise trains ``onn`` off-chip by BP through its meshes: the mesh
    kernel forward (the resident design; at hidden 1024 also the wide
    routes A and B) and ``mesh_apply_stacked_grad`` backward (the resident
    backward; for the wide meshes the backward of their forward's route:
    the dense one after route B on the stencil's rows, the warp-rows one
    after route A).

The validation MSEs are taken with ``validation_mse`` (``tt_contract``,
and one grouped densification per tonn evaluation).  Off-chip ``onn``
at a width whose meshes no backward kernel holds (past 1024 ports: the
owner walk's) exits, naming ROADMAP queue A, item 6c-3.
Quantization-aware rows (the JAX row's ``quant=``) are item 11's.

Random draws come from ``device.counter_generator``, not JAX's threefry:
the params and chip from ``(seed)`` and ``(seed, 99)`` (the trainer's
``init_solver``), epoch i's batch from ``(seed, i, 0)`` (the trainer's
collocation iterator) and, for a problem with a boundary loss
(helmholtz-2d), its ``max(batch // 4, 8)`` boundary rows from the
trainer's term iterator (``(seed, i, 1, term)``), passed to both arms as
``term_batches``, ξ from ``(seed + 1, i)`` (``zoo.ZOState``) and the
seed-independent validation points from ``(1234)``.  ``run_row`` also
takes the arrays a JAX row drew (``params0``, ``hw_noise``, ``batches``,
``val`` and the on-chip row's ``xis``; numpy, as ``load_arrays`` reads the
``.npz`` that ``benchmarks/table1_bar_reference.py`` writes) and then uses
them instead.  With all of them but ``xis`` handed over, ``seed`` sets
only the ξ draws.

``--bar REFERENCE_JSON ARRAYS_NPZ`` runs the north-star bar (ROADMAP 7a):
the proposed row for every ``--seeds`` seed on the JAX row's validation
points, and the verdict: the median of the port's ``val_mse_mapped``
within the min–max of the JAX seeds'.  Then, from the JAX seed's own
params, chip and batches, one run for each ``--seeds`` seed of ξ (how far
ξ alone moves the result) and, where the ``.npz`` holds JAX's ξ, one run
with those too (nothing of the row's draws differs from the JAX run);
where it holds JAX's f32 and f64 losses at the initial params, the port's
beside them (``initial_losses``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import pinn, zoo
from repro_torch.core.photonic import NoiseModel
from repro_torch.data import pde_term_batch_iterator
from repro_torch.device import counter_generator, resolve_device, to_device
from repro_torch.kernels import mesh_apply, tt_contract

VAL_SEED = 1234          # the JAX row's PRNGKey(1234): one set for every seed
VAL_POINTS = 1000

# (mode, on_chip, noise) of ``run``: the JAX benchmark's four rows
ROWS = (("tt", False, False),     # off-chip TT, ideal
        ("tt", False, True),      # off-chip TT mapped to noisy hw
        ("tonn", True, True),     # PROPOSED: on-chip ZO TT w/ noise
        ("dense", False, False))  # off-chip dense (ONN pre-map), ideal
# the paper's five rows at its width: ``run``'s and the on-chip ONN
PAPER_ROWS = ROWS + (("onn", True, True),)
PROPOSED = ("tonn", True, True)

COUNTED = ("tt_contract", "tt_contract_grad", "tt_contract_batched",
           "tt_contract_batched_quant", "mesh_densify_stacked",
           "mesh_densify_grad", "mesh_apply_stacked",
           "mesh_apply_stacked_grad")


def row_name(mode: str, on_chip: bool, noise: bool) -> str:
    """The JAX benchmark's row name (of the mode asked for, before the
    noise remap)."""
    return (f"table1/{mode}-{'on' if on_chip else 'off'}chip-"
            f"{'noisy' if noise else 'ideal'}")


def _remap(mode: str, noise: bool) -> str:
    # hardware noise lives in the MZI phase domain: noisy rows need the
    # photonic parametrization (tt→tonn, dense→onn)
    if noise and mode in ("tt", "dense"):
        return {"tt": "tonn", "dense": "onn"}[mode]
    return mode


def unported(mode: str, on_chip: bool, noise: bool, hidden: int = 1024,
             pde: str = "hjb-20d") -> str | None:
    """Why the port cannot run this row at ``hidden`` yet, or None."""
    if _remap(mode, noise) == "onn" and not on_chip:
        held = pinn.onn_no_backward_ports(pinn.PINNConfig(
            hidden=hidden, mode="onn", pde=pde))
        if held:
            return (f"{row_name(mode, on_chip, noise)} trains onn off-chip "
                    f"by BP through its meshes; at hidden {hidden} the "
                    f"{held}-port meshes take the owner walk, whose "
                    "backward is ROADMAP queue A, item 6c-3")
    return None


def load_arrays(path: str) -> dict:
    """The ``.npz`` of ``benchmarks/table1_bar_reference.py`` as
    ``run_row``'s keyword arguments: ``params0`` and ``hw_noise`` (numpy
    trees), ``batches`` and ``val`` (arrays)."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    tree = interop.tree_from_flat(
        {k: v for k, v in flat.items() if "/" in k})
    return {"params0": tree["params"], "hw_noise": tree.get("hw_noise"),
            "batches": flat["batches"], "val": flat["val"],
            "xis": tree.get("xis")}


def _bp_step(model, params: dict, mask: dict, xt: torch.Tensor,
             tb: dict, lr_t: float) -> tuple:
    """One off-chip step on the ideal model: ``p − lr_t·g`` with the fixed
    buffers' gradients zeroed (they are not asked for); ``tb`` the
    boundary/data term batches."""
    p = zoo.tree_map(lambda t, train: t.detach().requires_grad_(train),
                     params, mask)
    # tonn: one grouped densification, its backward one launch too
    prepared, _ = model.prepare_params(p, None)
    loss = pinn.residual_loss(model, prepared, xt, None, term_batches=tb)
    wanted = [t for t in zoo.tree_leaves(p) if t.requires_grad]
    found = dict(zip(map(id, wanted), torch.autograd.grad(
        loss, wanted, materialize_grads=True)))
    new = zoo.tree_map(lambda t: (t - lr_t * found[id(t)]).detach()
                       if t.requires_grad else t, p)
    return new, loss.detach()


def run_row(mode: str, on_chip: bool, noise: bool, hidden: int = 64,
            epochs: int = 600, batch: int = 100, seed: int = 0,
            tt_rank: int = 2, tt_L: int = 3, lr: float = 2e-3,
            sequential: bool = False, pde: str = "hjb-20d",
            device: str | torch.device = "cuda", params0=None,
            hw_noise=None, batches=None, val=None, xis=None) -> dict:
    """One Table-1 cell on the workload ``pde``, as the JAX row runs it.
    Returns {val_mse_mapped, val_mse_ideal, params, seconds, ...} (val
    MSEs are NaN for problems without a closed-form solution) and
    ``ms_per_step``: the steps' time on CUDA events over the whole loop
    (None on the CPU).

    off-chip = BP training on the ideal model, then (if noise) map the
    trained weights onto noisy hardware and report the degraded loss.
    on-chip = ZO-signSGD directly on the (noisy) photonic parameters,
    through the fused stacked path; ``sequential=True`` evaluates the N+1
    models one at a time.  ``params0``, ``hw_noise``, ``batches``
    ((epochs, batch, in_dim)), ``val`` and, on-chip, ``xis`` (a params
    tree of (epochs, N, *leaf) stacks) (numpy) replace the row's own
    draws."""
    reason = unported(mode, on_chip, noise, hidden, pde)
    if reason:
        raise NotImplementedError(reason)
    if xis is not None and not on_chip:
        raise ValueError("xis are the on-chip row's ZO perturbations")
    mode = _remap(mode, noise)
    dev = resolve_device(device)
    cfg = pinn.PINNConfig(hidden=hidden, mode=mode, tt_rank=tt_rank,
                          tt_L=tt_L, noise=NoiseModel(enabled=noise), pde=pde)
    model = pinn.TensorPinn(cfg)
    problem = model.problem
    params = (interop.params_from_numpy(params0, dev) if params0 is not None
              else to_device(model.init(counter_generator(seed)), dev))
    chip = None
    if noise:
        chip = (interop.noise_from_numpy(hw_noise, dev)
                if hw_noise is not None else
                to_device(model.sample_noise(counter_generator(seed, 99)),
                          dev))
    val_pts = (torch.from_numpy(np.asarray(val, np.float32))
               if val is not None else
               problem.sample_collocation(counter_generator(VAL_SEED),
                                          VAL_POINTS)).to(dev)

    def batch_at(i):
        xt = (torch.from_numpy(np.asarray(batches[i], np.float32))
              if batches is not None else
              problem.sample_collocation(counter_generator(seed, i, 0), batch))
        return xt.to(dev)

    def terms_at(i):
        # the trainer's term stream: a problem with a boundary loss draws
        # max(batch // 4, 8) boundary rows an epoch; others draw nothing
        return to_device(next(pde_term_batch_iterator(
            max(batch // 4, 8), seed=seed, start_step=i, problem=problem)),
            dev)

    cuda = dev.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.time()
    mask = model.trainable_mask(params)
    loss = torch.zeros(())
    if on_chip:
        # the paper's proposed method: forward-only ZO-signSGD on-device,
        # perturbing/updating only the trainable leaves (the photonic ±1
        # diag buffers stay bit-identical)
        scfg = zoo.SPSAConfig(num_samples=10, mu=0.01)
        state = zoo.ZOState(step=0, seed=seed + 1)
        xi_steps = (None if xis is None else
                    interop.params_from_numpy(xis, dev))
        for i in range(epochs):
            xt, tb = batch_at(i), terms_at(i)
            lr_t = lr * (0.5 ** (i / max(epochs // 3, 1)))
            params, state, loss = zoo.zo_signsgd_step(
                params, state, lr_t, scfg,
                batched_loss_fn=None if sequential else
                (lambda sp: pinn.residual_losses_stacked(
                    model, sp, xt, chip, term_batches=tb)),
                trainable_mask=mask,
                loss_fn=lambda p: pinn.residual_loss(model, p, xt, chip,
                                                     term_batches=tb),
                xis=None if xi_steps is None else
                zoo.tree_map(lambda z: z[i], xi_steps))
    else:
        # off-chip: BP on the ideal model (no noise during training), a
        # plain update, then map onto the hardware: evaluate WITH the
        # noise it never saw
        for i in range(epochs):
            lr_t = 10 * lr * (0.5 ** (i / max(epochs // 3, 1)))
            params, loss = _bp_step(model, params, mask, batch_at(i),
                                    terms_at(i), lr_t)
    ms_per_step = None
    if cuda:
        end.record()
        torch.cuda.synchronize()
        ms_per_step = start.elapsed_time(end) / max(epochs, 1)

    if problem.has_exact_solution:
        with torch.no_grad():
            ideal = float(pinn.validation_mse(model, params, val_pts, None))
            mapped = float(pinn.validation_mse(model, params, val_pts, chip))
    else:
        ideal = mapped = float("nan")
    return {"mode": mode, "on_chip": on_chip, "noise": noise, "pde": pde,
            "val_mse_mapped": mapped, "val_mse_ideal": ideal,
            "final_loss": float(loss),
            "params": int(sum(t.numel() for t in zoo.tree_leaves(params))),
            "seconds": round(time.time() - t0, 1),
            "ms_per_step": ms_per_step}


def run(hidden: int = 64, epochs: int = 400,
        device: str | torch.device = "cuda") -> list:
    """CI-scale Table 1: the paper's ordering must reproduce —
    on-chip ZO (noise) ≪ off-chip mapped-to-noisy-hardware."""
    rows = []
    for mode, on_chip, noise in ROWS:
        r = run_row(mode, on_chip, noise, hidden=hidden, epochs=epochs,
                    device=device)
        r["name"] = row_name(mode, on_chip, noise)
        rows.append(r)
    return rows


GRAD_KEYS = tuple(f"grad_{d}" for d in mesh_apply.GRAD_DESIGNS)


def kernel_launches(reset: bool = False) -> dict:
    """The port's kernel launch counts (each wrapper's, the mesh kernel's
    per design and route, and its backward's per design as
    ``grad_<design>``); ``reset`` sets them to 0 first."""
    wrappers = {name: getattr(tt_contract if name.startswith("tt")
                              else mesh_apply, name) for name in COUNTED}
    fwd, bwd = mesh_apply.mesh_apply_stacked, \
        mesh_apply.mesh_apply_stacked_grad
    if reset:
        for fn in wrappers.values():
            fn.launches = 0
        fwd.design_launches = dict.fromkeys(mesh_apply.DESIGNS, 0)
        bwd.design_launches = dict.fromkeys(mesh_apply.GRAD_DESIGNS, 0)
    counts = {name: fn.launches for name, fn in wrappers.items()}
    counts.update(fwd.design_launches)
    counts.update({f"grad_{k}": v for k, v in bwd.design_launches.items()})
    return counts


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def _counted_row(key: tuple, **kw) -> dict:
    kernel_launches(reset=True)
    r = run_row(*key, **kw)
    r["name"] = row_name(*key)
    r["hidden"] = kw["hidden"]
    r["launches"] = kernel_launches()
    print(json.dumps(r), flush=True)
    return r


def initial_losses(arrays: dict, k: int, hidden: int, tt_L: int,
                   pde: str = "hjb-20d", tt_rank: int = 2,
                   device: str | torch.device = "cuda") -> list:
    """The proposed row's loss, as its ZO step takes it (a stack of one),
    at ``arrays``' initial params and chip on their first ``k`` batches."""
    dev = resolve_device(device)
    model = pinn.TensorPinn(pinn.PINNConfig(
        hidden=hidden, mode="tonn", tt_rank=tt_rank, tt_L=tt_L,
        noise=NoiseModel(enabled=True), pde=pde))
    one = zoo.tree_map(lambda t: t[None],
                       interop.params_from_numpy(arrays["params0"], dev))
    chip = interop.noise_from_numpy(arrays["hw_noise"], dev)
    with torch.no_grad():
        return [float(pinn.residual_losses_stacked(
            model, one, torch.from_numpy(np.asarray(b, np.float32)).to(dev),
            chip)[0]) for b in arrays["batches"][:k]]


def bar_verdict(port: list, reference: list) -> dict:
    """The 7a bar: the median of the port's ``val_mse_mapped`` within the
    min–max of the reference seeds'."""
    med = statistics.median(port)
    lo, hi = min(reference), max(reference)
    return {"port_median": med, "reference_min": lo, "reference_max": hi,
            "passed": lo <= med <= hi}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Paper Table 1 on the port")
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--tt-L", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=5000)
    ap.add_argument("--pde", default="hjb-20d")
    ap.add_argument("--seeds", default="0",
                    help="comma-separated seeds, each row at each")
    ap.add_argument("--rows", default=",".join(
        row_name(*k).split("/")[1] for k in PAPER_ROWS),
        help="comma-separated row names (table1/<name>)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU only cpu runs")
    ap.add_argument("--out", required=True,
                    help="the JSON file this invocation's record is "
                         "appended to (under \"runs\")")
    ap.add_argument("--bar", nargs=2, metavar=("REFERENCE_JSON", "ARRAYS_NPZ"),
                    default=None,
                    help="the 7a bar against benchmarks/"
                         "table1_bar_reference.py's outputs (the proposed "
                         "row only)")
    args = ap.parse_args(argv)

    keys = {row_name(*k).split("/")[1]: k
            for k in PAPER_ROWS + (("dense", False, True),)}
    wanted = [keys[name] for name in args.rows.split(",")]
    if args.bar:
        wanted = [PROPOSED]
    blocked = [r for r in (unported(*k, args.hidden, args.pde)
                           for k in wanted) if r]
    if blocked:
        raise SystemExit("; ".join(blocked))
    device = resolve_device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    kw = dict(hidden=args.hidden, tt_L=args.tt_L, epochs=args.epochs,
              pde=args.pde, device=device)
    out = {"device": {"type": device.type,
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else None),
                      "nvidia_smi": (card_line() if device.type == "cuda"
                                     else None)},
           "torch": torch.__version__,
           "config": {"hidden": args.hidden, "tt_rank": 2, "tt_L": args.tt_L,
                      "batch": 100, "spsa_samples": 10, "lr": 2e-3,
                      "epochs": args.epochs, "pde": args.pde},
           "rows": []}
    if args.bar:
        with open(args.bar[0]) as f:
            reference = json.load(f)
        if reference.get("arrays_seed") is None:
            raise SystemExit(f"{args.bar[0]} names no arrays_seed: the seed "
                             f"whose draws {args.bar[1]} holds is unknown")
        arrays = load_arrays(args.bar[1])
        for seed in seeds:
            r = _counted_row(PROPOSED, seed=seed, val=arrays["val"], **kw)
            out["rows"].append({"seed": seed, **r})
        ref_runs = reference["runs"]
        out["bar"] = {
            "reference": {k: reference[k] for k in reference if k != "runs"},
            "reference_runs": [
                {k: r[k] for k in ("seed", "val_mse_mapped", "val_mse_ideal",
                                   "final_loss", "seconds")}
                for r in ref_runs],
            "verdict": bar_verdict(
                [r["val_mse_mapped"] for r in out["rows"]],
                [r["val_mse_mapped"] for r in ref_runs])}
        print(f"[bar] {json.dumps(out['bar']['verdict'])}", flush=True)
        # the JAX seed's own params, chip and batches: only ξ differs
        shared = {k: v for k, v in arrays.items() if k != "xis"}
        own_xi = [{"seed": seed, **_counted_row(PROPOSED, seed=seed,
                                                **shared, **kw)}
                  for seed in seeds]
        mapped = [r["val_mse_mapped"] for r in own_xi]
        out["bar"]["shared_init"] = {
            "arrays_seed": reference["arrays_seed"],
            "reference": next(r for r in ref_runs
                              if r["seed"] == reference["arrays_seed"]),
            "port_own_xi": own_xi,
            "xi_spread": {"min": min(mapped),
                          "median": statistics.median(mapped),
                          "max": max(mapped)},
            "port_reference_xi": (
                None if arrays["xis"] is None else
                _counted_row(PROPOSED, seed=reference["arrays_seed"],
                             **arrays, **kw))}
        with np.load(args.bar[1]) as f:
            floor = {k.split("/")[1]: f[k].tolist() for k in f.files
                     if k.startswith("loss_floor/")}
        if floor:
            f64 = np.asarray(floor["f64"])
            port = initial_losses(arrays, len(f64), args.hidden, args.tt_L,
                                  args.pde, device=device)
            out["bar"]["shared_init"]["loss_floor"] = {
                "jax_f32": floor["f32"], "jax_f64": floor["f64"],
                "port_f32": port,
                "jax_f32_rel": (np.abs(floor["f32"] / f64 - 1)).tolist(),
                "port_f32_rel": (np.abs(port / f64 - 1)).tolist()}
    else:
        for key in wanted:
            for seed in seeds:
                out["rows"].append({"seed": seed,
                                    **_counted_row(key, seed=seed, **kw)})
    # one record per invocation, appended: each with its own card line
    doc = {"runs": []}
    if os.path.exists(args.out):
        with open(args.out) as f:
            doc = json.load(f)
    doc["runs"].append(out)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    return out


if __name__ == "__main__":
    main()
