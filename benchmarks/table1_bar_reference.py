"""The JAX package's side of the port's hjb-20d training bar (ROADMAP 7a).

Runs ``table1_hjb.run_row`` for the proposed Table 1 row (tonn, on-chip
ZO-signSGD, noise on) at the paper's width for several seeds, and writes
each seed's validation MSEs to a JSON file.  It also writes, as an
``.npz`` of ``/``-joined path keys, the arrays one seed's row drew: its
initial params (``params/...``), its chip noise (``hw_noise/...``), the
collocation batch of every epoch (``batches``, (epochs, batch, in_dim)),
the seed-independent validation points (``val``) and, with ``--xis``,
the ZO perturbations of every epoch (``xis/...``, (epochs, N, *leaf))
and, with ``--loss-floor K``, JAX's residual loss at the initial params
on the first K batches in f32 and in f64 (``loss_floor/f32``,
``loss_floor/f64``: how far f32 sits from the FD loss it estimates).
The port's ``benchmarks/torch_table1_hjb.py --bar JSON NPZ`` reads both
files: its seeds are evaluated on the same points, and runs start from
the same params, chip and batches, with its own ξ draws of several seeds
and, where the ``.npz`` holds them, with JAX's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python benchmarks/table1_bar_reference.py \\
        --seeds 0,1,2,3,4 --epochs 1000 --out bar_jax.json \\
        --arrays-seed 0 --arrays bar_jax_seed0.npz --xis --loss-floor 8

The draws are ``run_row``'s own, made again with the same keys:
``PRNGKey(seed)`` for the params, ``fold_in(key, 99)`` for the noise,
``fold_in(key, i)`` for epoch i's batch, ``PRNGKey(1234)`` for the
validation points, and epoch i's ξ from the i-th split of
``ZOState.create(seed + 1)``'s key, as ``zoo.zo_signsgd_step`` splits it.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import pinn, zoo
from repro.core.photonic import NoiseModel

try:
    from benchmarks.table1_hjb import run_row
except ImportError:  # invoked as `python benchmarks/table1_bar_reference.py`
    from table1_hjb import run_row


def _flat(tree, prefix: str) -> dict:
    """``{"prefix/a/0/b": array}`` from a nested dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree, dtype=np.float32)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def row_arrays(seed: int, epochs: int, hidden: int, tt_L: int,
               tt_rank: int = 2, batch: int = 100, pde: str = "hjb-20d",
               mode: str = "tonn", noise: bool = True, xis: bool = False,
               num_samples: int = 10) -> dict:
    """The arrays ``run_row`` draws for ``seed`` in ``mode`` (after its
    noise remap; default the proposed row), flattened for ``np.savez``;
    ``xis`` adds the on-chip row's ξ stack of every epoch."""
    cfg = pinn.PINNConfig(hidden=hidden, mode=mode, tt_rank=tt_rank,
                          tt_L=tt_L, noise=NoiseModel(enabled=noise), pde=pde)
    model = pinn.TensorPinn(cfg)
    problem = model.problem
    key = jax.random.PRNGKey(seed)
    params = model.init(key)
    out = _flat(params, "params")
    if noise:
        out.update(_flat(model.sample_noise(jax.random.fold_in(key, 99)),
                         "hw_noise"))
    out["batches"] = np.stack([
        np.asarray(problem.sample_collocation(jax.random.fold_in(key, i),
                                              batch)) for i in range(epochs)])
    out["val"] = np.asarray(
        problem.sample_collocation(jax.random.PRNGKey(1234), 1000))
    if xis:
        mask = model.trainable_mask(params)
        draw = jax.jit(lambda k: zoo.sample_perturbations(
            k, params, num_samples, mask))
        zkey, steps = zoo.ZOState.create(seed + 1).key, []
        for _ in range(epochs):
            zkey, sub = jax.random.split(zkey)
            steps.append(_flat(draw(sub), "xis"))
        out.update({k: np.stack([s[k] for s in steps]) for k in steps[0]})
    return out


def loss_floor(seed: int, k: int, hidden: int, tt_L: int, tt_rank: int = 2,
               batch: int = 100, pde: str = "hjb-20d") -> dict:
    """The proposed row's ``residual_loss`` at ``seed``'s initial params
    and chip on its first ``k`` batches, in f32 and in f64 (the same f32
    draws, cast), flattened for ``np.savez``."""
    cfg = pinn.PINNConfig(hidden=hidden, mode="tonn", tt_rank=tt_rank,
                          tt_L=tt_L, noise=NoiseModel(enabled=True), pde=pde)
    model = pinn.TensorPinn(cfg)
    key = jax.random.PRNGKey(seed)
    params = model.init(key)
    noise = model.sample_noise(jax.random.fold_in(key, 99))
    batches = [np.asarray(model.problem.sample_collocation(
        jax.random.fold_in(key, i), batch)) for i in range(k)]

    def losses(dtype):
        cast = lambda t: jax.tree.map(lambda x: jnp.asarray(x, dtype), t)
        return np.array([float(pinn.residual_loss(
            model, cast(params), jnp.asarray(b, dtype), cast(noise)))
            for b in batches])

    f32 = losses(jnp.float32)
    with jax.enable_x64(True):
        f64 = losses(jnp.float64)
    return {"loss_floor/f32": f32, "loss_floor/f64": f64}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--tt-L", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default="bar_jax.json")
    ap.add_argument("--arrays-seed", type=int, default=0)
    ap.add_argument("--arrays", default=None,
                    help="write that seed's draws to this .npz")
    ap.add_argument("--xis", action="store_true",
                    help="with --arrays: add every epoch's ξ stack")
    ap.add_argument("--loss-floor", type=int, default=0, metavar="K",
                    help="with --arrays: add the f32 and f64 losses at the "
                         "initial params on the first K batches")
    args = ap.parse_args(argv)

    if args.arrays:
        floor = (loss_floor(args.arrays_seed, args.loss_floor, args.hidden,
                            args.tt_L) if args.loss_floor else {})
        np.savez(args.arrays, **row_arrays(args.arrays_seed, args.epochs,
                                           args.hidden, args.tt_L,
                                           xis=args.xis), **floor)
    result = {"row": "table1/tonn-onchip-noisy", "hidden": args.hidden,
              "tt_L": args.tt_L, "epochs": args.epochs, "lr": args.lr,
              "jax": jax.__version__, "backend": jax.default_backend(),
              "arrays_seed": args.arrays_seed if args.arrays else None,
              "runs": []}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        r = run_row("tonn", True, True, hidden=args.hidden,
                    epochs=args.epochs, seed=seed, tt_L=args.tt_L,
                    lr=args.lr)
        r["seed"], r["wall_s"] = seed, time.time() - t0
        result["runs"].append(r)
        print(json.dumps(r), flush=True)
        with open(args.out, "w") as f:       # kept current after each seed
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
