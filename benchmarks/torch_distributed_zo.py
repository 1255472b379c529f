"""Distributed ZO training on the PyTorch port: the SPSA sweep sharded over
a world of ranks (``repro_torch.parallel.zo_shard``).  The port of
``benchmarks/distributed_zo.py``: the same three measurements and row
keys, from one world of spawned ranks, 2 (8 with ``--ci``) (``gloo``; on
the card every rank takes ``cuda:{rank % device_count()}``, so one H100
holds them all).

  * **layouts** — ms a step of the distributed ZO-signSGD step at the
    paper's 20-dim HJB config (tonn, ``tt_L`` 3, as the reference) across
    layouts: the single-rank fused step (``zoo.zo_signsgd_step``, rank 0
    alone), 1×1, perturbation-sharded, batch-sharded and both, as many as
    the world holds.  The ranks share one card (or the host's cores), so
    parity, not speedup, is what a layout can show here; the numbers are
    the layouts' overhead.  Each row has its bytes on the wire a step,
    every collective counted (``measure_collective_bytes``), against the
    O(N)-scalar bound and the params' bytes; the script fails past
    either.
  * **traffic** — those rows' ``wire_bytes_per_step`` and
    ``collectives``.
  * **identity** — for every registered PDE, the distributed gradient on
    the world's widest perturbation layout and on a layout with a batch
    axis against the single-rank fused ``zoo.spsa_gradient`` of the same
    ξ (the same generator seed): the largest deviation within 1e-4 of the
    gradient's scale plus 1e-5 (the reference's tolerance), and whether
    it is bit-equal.

    PYTHONPATH=src python benchmarks/torch_distributed_zo.py \\
        --out BENCH_torch_distributed_zo.json            # 2 ranks, card
    PYTHONPATH=src python benchmarks/torch_distributed_zo.py --ci \\
        --out build/dz.json                              # 8 CPU ranks, toy

``--ci`` runs 8 ranks on the CPU at hidden 64 and batch 32, as the
reference's ``--ci``, and the identity rows at hidden 16, batch 32 (16
points a rank on the 4x2 layout); otherwise they run at the reference's
hidden 32, batch 64, N = 6.  The record carries the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # invoked as `python benchmarks/...`
    sys.path.insert(0, str(ROOT))

from repro_torch import pde as pde_lib  # noqa: E402
from repro_torch.core import pinn, zoo  # noqa: E402
from repro_torch.device import counter_generator, resolve_device  # noqa: E402
from repro_torch.parallel import zo_shard  # noqa: E402

GRAD_IDENTITY_TOL = 1e-4   # of the gradient's scale (the f32 floor)
GRAD_IDENTITY_ATOL = 1e-5  # gradients near zero (helmholtz-2d) sit on
#                            f32-epsilon deviations meaningless for sign(g)


def _setup(pde: str, hidden: int, batch: int, num_samples: int,
           device: torch.device, seed: int = 0) -> tuple:
    """The reference benchmark's model (tonn, ``tt_L`` 3, fd_fast, fused),
    params, batch and stacked loss, on ``device``."""
    model = pinn.TensorPinn(pinn.PINNConfig(
        hidden=hidden, mode="tonn", tt_L=3, pde=pde, deriv="fd_fast",
        use_fused_kernel=True))
    params = zoo.tree_map(lambda t: t.to(device),
                          model.init(counter_generator(seed)))
    mask = model.trainable_mask(params)
    xt = model.problem.sample_collocation(counter_generator(seed, 1),
                                          batch).to(device)
    scfg = zoo.SPSAConfig(num_samples=num_samples, mu=0.01)

    def blf(sp, x, bc=None):
        return pinn.residual_losses_stacked(model, sp, x)

    return model, params, xt, scfg, blf, mask


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_steps(step, params, device, repeats: int) -> dict:
    """Host ms of each of ``repeats`` steps after one warm-up (synced),
    their median, and on the card the CUDA-event mean over them."""
    p, s = params, zoo.ZOState(step=0, seed=1)
    p, s, loss = step(p, s)
    _sync(device)
    ts = []
    start = end = None
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    for _ in range(repeats):
        t0 = time.perf_counter()
        p, s, loss = step(p, s)
        float(loss)                      # waits for the step
        ts.append((time.perf_counter() - t0) * 1e3)
    out = {"step_ms": statistics.median(ts), "host_ms": ts}
    if start is not None:
        end.record()
        torch.cuda.synchronize(device)
        out["event_ms"] = start.elapsed_time(end) / repeats
    return out


def _layouts(world: int, batch: int) -> list:
    """(name, spec, shard) of every layout the world holds, as the
    reference picks them from its device count."""
    rows = [("single", None, None), ("1x1", "1x1", "perturbation")]
    for p in sorted({p for p in (2, 4, world) if 1 < p <= world}):
        rows.append((f"pert {p}x1", f"{p}x1", "perturbation"))
    if world > 1 and batch % world == 0:
        rows.append((f"batch 1x{world}", f"1x{world}", "batch"))
    if world >= 4 and batch % 2 == 0:
        rows.append((f"both {world // 2}x2", f"{world // 2}x2", "both"))
    return rows


def bench_layouts(rank: int, world: int, device, pde: str, hidden: int,
                  batch: int, num_samples: int, repeats: int) -> list:
    model, params, xt, scfg, blf, mask = _setup(pde, hidden, batch,
                                                num_samples, device)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in zoo.tree_leaves(params))
    rows = []
    for name, spec, shard in _layouts(world, batch):
        mesh = (zo_shard.make_zo_mesh(spec, shard) if spec
                else zo_shard.make_zo_mesh("1x1", ranks=[0]))
        row = {"layout": name, "pert": mesh.shape["pert"],
               "batch_shards": mesh.shape["batch"], "devices": mesh.size}
        if mesh.member:
            if spec is None:
                # the single-rank fused step (the trainer's hot path)
                def step(p, s):
                    return zoo.zo_signsgd_step(
                        p, s, 1e-3, scfg, lambda sp: blf(sp, xt),
                        trainable_mask=mask)
                traffic = {"bytes": 0, "ops": []}
            else:
                dstep = zo_shard.make_distributed_zo_step(
                    mesh, blf, scfg, trainable_mask=mask)

                def step(p, s):
                    return dstep(p, s, xt, None, 1e-3)
                traffic = zo_shard.measure_collective_bytes(
                    step, params, zoo.ZOState(step=0, seed=1))
            with torch.no_grad():
                row.update(_time_steps(step, params, device, repeats))
            bound = zo_shard.wire_bound_bytes(num_samples, row["pert"])
            row.update(wire_bytes_per_step=traffic["bytes"],
                       wire_bound_bytes=bound, param_bytes=param_bytes,
                       collectives=[f"{op} {shapes}" for op, shapes, _
                                    in traffic["ops"]])
            if not traffic["bytes"] <= bound < param_bytes:
                raise AssertionError(f"{name}: {traffic['bytes']} bytes on "
                                     f"the wire, bound {bound}, params "
                                     f"{param_bytes}")
        dist.barrier()                   # the single arm runs on rank 0 alone
        rows.append(row)
    return rows


def bench_identity(rank: int, world: int, device, hidden: int, batch: int,
                   num_samples: int) -> list:
    """The distributed gradient against the single-rank fused one of the
    same ξ, every registered PDE."""
    specs = [(f"{world}x1", "perturbation"),
             (f"{world // 2}x2", "both") if world >= 4
             else (f"1x{world}", "batch")]
    meshes = [(spec, zo_shard.make_zo_mesh(spec, shard))
              for spec, shard in specs]
    rows = []
    for pde in pde_lib.available():
        model, params, xt, scfg, blf, mask = _setup(pde, hidden, batch,
                                                    num_samples, device)
        with torch.no_grad():
            g_ref, _ = zoo.spsa_gradient(
                params, counter_generator(2, device=device), scfg,
                lambda sp: blf(sp, xt), mask)
        scale = max(float(g.abs().max()) for g in zoo.tree_leaves(g_ref))
        row = {"pde": pde, "grad_scale": scale}
        for spec, mesh in meshes:
            grad_fn = zo_shard.make_distributed_spsa_gradient(
                mesh, lambda sp, x: blf(sp, x), scfg, trainable_mask=mask)
            with torch.no_grad():
                g, _ = grad_fn(params, counter_generator(2, device=device),
                               xt)
            pairs = list(zip(zoo.tree_leaves(g), zoo.tree_leaves(g_ref)))
            err = max(float((a - b).abs().max()) for a, b in pairs)
            row[f"abs_err_{spec}"] = err
            row[f"rel_err_{spec}"] = err / (scale + 1e-30)
            row[f"bit_equal_{spec}"] = all(torch.equal(a, b)
                                           for a, b in pairs)
        row["identity"] = bool(
            max(v for k, v in row.items() if k.startswith("abs_err"))
            < GRAD_IDENTITY_TOL * scale + GRAD_IDENTITY_ATOL)
        rows.append(row)
    return rows


def _bench_rank(rank: int, world: int, kw: dict) -> dict:
    device = resolve_device(kw["device"])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return {"layouts": bench_layouts(
                rank, world, device, kw["pde"], kw["hidden"], kw["batch"],
                kw["num_samples"], kw["repeats"]),
            "identity": bench_identity(
                rank, world, device, kw["id_hidden"], kw["id_batch"],
                kw["id_samples"])}


def run(world: int = 2, hidden: int = 1024, batch: int = 96,
        num_samples: int = 10, repeats: int = 10, pde: str = "hjb-20d",
        id_hidden: int = 32, id_batch: int = 64, id_samples: int = 6,
        device: str = "cuda") -> dict:
    dev = resolve_device(device)
    kw = dict(device=str(dev.type), pde=pde, hidden=hidden, batch=batch,
              num_samples=num_samples, repeats=repeats, id_hidden=id_hidden,
              id_batch=id_batch, id_samples=id_samples)
    card = None
    if dev.type == "cuda":
        from benchmarks.torch_table1_hjb import card_line
        from repro_torch.kernels import _build
        card = card_line()
        for name in ("tt_contract", "mesh_apply"):   # before the spawn
            _build.build(name)
    outs = zo_shard.run_ranks(_bench_rank, world, kw, device=dev)
    layouts = []
    for i, row in enumerate(outs[0]["layouts"]):
        # every member rank's median, the slowest beside rank 0's
        ms = [o["layouts"][i]["step_ms"] for o in outs
              if "step_ms" in o["layouts"][i]]
        layouts.append({**row, "step_ms_ranks": ms})
    return {"config": {"pde": pde, "hidden": hidden, "batch": batch,
                       "num_samples": num_samples, "world": world,
                       "identity": {"hidden": id_hidden, "batch": id_batch,
                                    "num_samples": id_samples},
                       "device": dev.type, "card": card,
                       "torch": torch.__version__,
                       "note": ("the ranks share one card (or the host's "
                                "cores): expect parity, not speedup")},
            "layouts": layouts, "identity": outs[0]["identity"]}


def summarize(result: dict) -> list:
    """Rows of a CSV summary, as the reference's."""
    out = [{"name": f"torch_distributed_zo/{r['layout'].replace(' ', '_')}",
            "us_per_call": round(r["step_ms"] * 1e3, 1),
            "derived": (f"wire={r['wire_bytes_per_step']}B "
                        f"(bound {r['wire_bound_bytes']}B, "
                        f"params {r['param_bytes']}B)")}
           for r in result["layouts"]]
    worst = max((max(v for k, v in r.items() if k.startswith("rel_err"))
                 for r in result["identity"]), default=0.0)
    out.append({"name": "torch_distributed_zo/identity", "us_per_call": "",
                "derived": f"{len(result['identity'])} PDEs, "
                           f"worst_rel_err={worst:.1e}"})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ci", action="store_true",
                    help="8 CPU ranks at hidden 64, batch 32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pde", default="hjb-20d")
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=96,
                    help="global collocation batch (the batch axis must "
                         "divide it; the paper uses 100)")
    ap.add_argument("--num-samples", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    world, identity = 2, {}
    if args.ci:
        world, args.device, args.hidden, args.batch = 8, "cpu", 64, 32
        args.repeats = min(args.repeats, 3)
        identity = {"id_hidden": 16, "id_batch": 32}
    result = run(world=world, hidden=args.hidden, batch=args.batch,
                 num_samples=args.num_samples, repeats=args.repeats,
                 pde=args.pde, device=args.device, **identity)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=2))
    for r in summarize(result):
        print(f"{r['name']},{r['us_per_call']},{r['derived']}")
    bad = [r["pde"] for r in result["identity"] if not r["identity"]]
    if bad:
        raise SystemExit(f"gradient identity violated: {bad}")
    print(f"[torch_distributed_zo] {len(result['layouts'])} layouts, "
          f"{len(result['identity'])} PDE identity checks OK"
          + (f" on {result['config']['card']}" if result["config"]["card"]
             else ""))
    return result


if __name__ == "__main__":
    main()
