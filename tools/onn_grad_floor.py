#!/usr/bin/env python3
"""The float64 rule of onn's card-vs-CPU BP gradients at hidden 1024 on one
GPU: what it reads on several seeds, and what it reads on a planted fault.

    python3 tools/onn_grad_floor.py [--seeds 0 1 2] [--steps 10]

At hidden 1024 the f32 gradients of the CPU's plain path sit above
1e-4·max|grad| from float64 (1,024 levels of rounding), so
``chip_smoke._card_vs_cpu_grads(f64_floor=True)`` holds the card's
gradients to the CPU's float64 ones within max(1e-4·max|grad|,
``chip_smoke.F32_FLOOR_FACTOR`` times the CPU f32 path's own distance).
For each seed this trains ``--pinn-mode onn --pinn-noise --optimizer
adamw`` (hidden 1024, batch 100) for ``--steps`` steps on the card, as
``chip_smoke.phase_train_bp`` does, and reads that rule on 4 points for
every function the check holds, without raising: each leaf's share of its
tolerance, and over the leaves whose tolerance the CPU f32 path's distance
to float64 sets, the card's distance over it (what the factor bounds).

The planted fault (first seed only): the sign bit of one slot, then of
every slot, of the 1024-port layout's slot map
(``mesh_apply.grad_slot_map``, ``MAP_NEG``) cleared in this process's
memo, so the warp-rows backward gives those phases' gradients the wrong
sign; the card's gradients of ``Σ u·w`` are then held to the same float64
references, and each leaf's share of its tolerance printed (a share above
1 is a fault the check catches).  The memo is restored after.  On 4
points every 1024-port mesh takes route A and the warp-rows backward;
the dense backward (route B's, from 1.5 × 1024 rows) walks the same slot
map, and the CPU's plain autograd cannot hold a model at that many rows
(~40 GB of saved levels), so the same rule and fault are read on the
mesh itself (``dense``): the hidden layer's U mesh of the trained model
on 4300 random rows, the dense backward's dx and dphases against the
plain backward's in float64 on the card, with the plain f32 one as the
own distance.

Prints one ``[onn-grad-floor]`` JSON line and the card's name and power
limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _refs(model, noise, fn, at, xt) -> tuple:
    """The CPU's f32 and float64 gradients of ``fn`` at ``at``."""
    import torch
    import chip_smoke
    cpu = torch.device("cpu")
    return (chip_smoke._bp_grads(model, noise, cpu, fn, at, xt)[1],
            chip_smoke._bp_grads(model, noise, cpu, fn, at, xt,
                                 torch.float64)[1])


def reading(card, plain, exact) -> dict:
    """The float64 rule's reading: each leaf's share of its tolerance, the
    worst share, and over the leaves whose tolerance the CPU f32 path's
    distance to float64 sets, the worst card distance over it."""
    import chip_smoke
    rule = chip_smoke._f64_floor_leaves(card, plain, exact)
    shares = [err / tol for err, tol, _ in rule]
    return {"leaf_shares": shares, "max_share": max(shares),
            "card_over_cpu_f64_distance": max(
                (r for _, _, r in rule if r is not None), default=None)}


def readings(model, params, init, noise, xt, device) -> tuple:
    """The rule on every function ``_card_vs_cpu_grads`` checks at hidden
    1024 (Σu·w at the trained params, the stencil at the initial and the
    trained ones, the loss at the initial ones), never raising; and the
    CPU references of Σu·w, for the planted faults."""
    import chip_smoke
    fns = chip_smoke._bp_grad_fns(model, xt.shape[0])
    out, u_refs = {}, None
    for name, key, at in (("Σu·w", "u final", params),
                          ("Σw·fd_u_stencil", "stencil init", init),
                          ("Σw·fd_u_stencil", "stencil final", params),
                          ("loss", "loss init", init)):
        _, card = chip_smoke._bp_grads(model, noise, device, fns[name], at,
                                       xt)
        refs = _refs(model, noise, fns[name], at, xt)
        out[key] = reading(card, *refs)
        if key == "u final":
            u_refs = refs
    return out, u_refs


@contextlib.contextmanager
def faulted_map(layout, rows: str):
    """The layout's slot map with its sign bit cleared in one slot
    (``rows="one"``: the first signed slot of the middle level) or in
    every slot (``"all"``), in this process's memo while the block runs;
    yields the number of slots changed."""
    import numpy as np
    from repro_torch.kernels import mesh_apply as mesh
    good = mesh.grad_slot_map(layout)
    bad = good.copy()
    signed = (bad >= 0) & ((bad & mesh.MAP_NEG) != 0)
    if rows == "one":
        mid = layout.levels // 2
        bad[mid, int(np.flatnonzero(signed[mid])[0])] &= ~mesh.MAP_NEG
    else:
        bad[signed] &= ~mesh.MAP_NEG
    try:
        object.__setattr__(layout, "_grad_slot_map", bad)
        layout.__dict__.pop("_grad_slot_map_tensors", None)
        yield int((bad != good).sum())
    finally:
        object.__setattr__(layout, "_grad_slot_map", good)
        layout.__dict__.pop("_grad_slot_map_tensors", None)


def planted(model, params, noise, xt, device, u_refs, rows: str) -> dict:
    """Σu·w's card gradients with the 1024-port slot map faulted
    (``faulted_map``), read by the float64 rule against the unfaulted CPU
    references (a share above 1 is caught)."""
    import chip_smoke
    from repro_torch.core import photonic
    layout = photonic.rectangular_layout(1024)      # cached: the model's
    fn = chip_smoke._bp_grad_fns(model, xt.shape[0])["Σu·w"]
    with faulted_map(layout, rows) as cleared:
        _, card = chip_smoke._bp_grads(model, noise, device, fn, params, xt)
    return {"slots_cleared": cleared, **reading(card, *u_refs)}


def planted_dense(model, params, device) -> dict:
    """The float64 rule on the dense backward (x and M from route B's
    forward) of the model's hidden-layer U mesh on 4300 random rows: its
    dx and dphases against ``ref.mesh_apply_grad_ref`` in float64 (the
    forward in float64 too), with the plain f32 backward's distance as
    the own one; clean, then with the slot map faulted in one slot and in
    every slot (``faulted_map``)."""
    import torch
    import chip_smoke
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.kernels import ref
    layout = model.photonic[1].layout_u
    P = layout.ports
    phases = params["p1"]["phases_u"].detach().to(
        device, torch.float32)[None].contiguous()
    diag = params["p1"]["diag_u"].detach().to(device,
                                              torch.float32).contiguous()
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((1, 4300, P), generator=gen).to(device)
    dy = torch.randn((1, 4300, P), generator=gen).to(device)
    y, dense = mesh.launch_dense_keep(layout, phases, diag, x)
    d64 = [t.double() for t in (phases, diag, x)]
    y64 = photonic.mesh_apply_stacked(layout, *d64)
    exact = ref.mesh_apply_grad_ref(layout, *d64, y64, dy.double())
    plain = ref.mesh_apply_grad_ref(layout, phases, diag, x, y, dy)

    def read(tag):
        card = mesh.mesh_apply_stacked_grad(layout, phases, diag, None, dy,
                                            x=x, dense=dense)
        rule = chip_smoke._f64_floor_leaves(card, plain, exact)
        shares = [err / tol for err, tol, _ in rule]
        return {"case": tag, "leaf_shares": shares,
                "max_share": max(shares)}
    out = {"clean": read("clean")}
    for rows in ("one", "all"):
        with faulted_map(layout, rows) as cleared:
            out[rows] = {"slots_cleared": cleared, **read(rows)}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("onn_grad_floor: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    import repro_torch
    from repro_torch.data import pde_collocation_iterator
    from repro_torch.device import to_device
    from repro_torch.launch import train
    _, _, card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    device = repro_torch.resolve_device("cuda")
    out = {"f32_floor_factor": chip_smoke.F32_FLOOR_FACTOR, "seeds": {}}
    for seed in args.seeds:
        res = train.main(["--arch", "tensor-pinn", "--pde", "hjb-20d",
                          "--pinn-mode", "onn", "--pinn-noise",
                          "--optimizer", "adamw", "--batch", "100",
                          "--steps", str(args.steps), "--log-every", "25",
                          "--seed", str(seed)])
        model = res.model
        xt = next(pde_collocation_iterator(
            100, seed=seed, start_step=args.steps,
            problem=model.problem))[:chip_smoke.ONN_CHECK_BATCH]
        init, _ = train.init_solver(model, seed)
        row, u_refs = readings(model, res.params, to_device(init, device),
                               res.hw_noise, xt, device)
        if seed == args.seeds[0]:
            row["planted"] = {rows: planted(model, res.params, res.hw_noise,
                                            xt, device, u_refs, rows)
                              for rows in ("one", "all")}
            row["planted"]["dense"] = planted_dense(model, res.params,
                                                    device)
        out["seeds"][seed] = row
        print(f"[onn-grad-floor] seed {seed} {json.dumps(row)}", flush=True)
    print(f"[onn-grad-floor] {json.dumps(out)}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
