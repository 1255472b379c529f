"""Distributed BP-free ZO training on ``torch.distributed``: the SPSA sweep
sharded over a ``("pert", "batch")`` layout of processes.

Zeroth-order training communicates only *scalars*: every loss ``L(Φ + μ
ξ_i)`` is one number, and with a shared generator seed every rank
regenerates every ξ_i itself.  Each rank of a P×B layout

  * draws the whole padded evaluation stack [0, ξ_1..ξ_N, 0…] of
    ``P · per`` entries (``pert_shard_size``) from
    ``counter_generator(state.seed, state.step)`` on its own device, as
    ``zoo.zo_signsgd_step`` draws it;
  * evaluates its ``per`` entries (the base loss rides along as entry 0)
    on its shard of the collocation batch through the stacked evaluator
    (``pinn.residual_losses_stacked``; on the card the chain and the
    grouped densification kernels of the fused step);
  * takes the mean of its slice over the ``"batch"`` axis (an
    ``all_reduce`` divided by B), *then* one ``all_reduce`` over
    ``"pert"`` of the zero-scattered (P · per,) f32 vector;
  * rebuilds the gradient locally (``zoo.spsa_gradient_from_losses``).

A step's traffic is those two vectors, O(N) scalars whatever the model's
size (``wire_bound_bytes``); parameters, ξ and gradients never leave a
rank.  ``measure_collective_bytes`` counts every collective a function
issues, so a parameter-sized transfer would show.

Gradient identity: every layout gives the single-rank fused
``zoo.spsa_gradient`` of the same ξ within float32 tolerance.  Each loss is
computed on one rank from the same inputs; batch sharding reassociates the
batch mean.  Whether a slice of ``per`` stacked entries is bit-equal to the
same entries of the full stack depends on the device's GEMMs, and is
measured rather than assumed.  Slices are floored at 2 entries, as in the
JAX package, so both pad the stack the same way.

Parameters are replicated, so resizing the world is rebuilding the layout
and the step over the surviving ranks and restoring the newest checkpoint
(``repro_torch.runtime.ZOElasticController``).

    mesh = make_zo_mesh("2x1", "perturbation")   # in an initialized world
    step = make_distributed_zo_step(mesh, batched_loss_fn, cfg)
    params, state, loss = step(params, state, xt, bc, lr)

``run_ranks`` runs a function on W new processes (``gloo`` over a
``file://`` rendezvous) and returns what each rank returned.

Port of ``repro.parallel.zo_shard``: ``shard_map`` over a device mesh
becomes one process a rank, ``psum``/``pmean`` become ``all_reduce`` over
the ``"pert"`` and ``"batch"`` process groups.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import zoo
from repro_torch.device import counter_generator, resolve_device

__all__ = [
    "PERT_AXIS", "BATCH_AXIS", "ZOShardConfig", "ZOMesh",
    "make_zo_mesh", "mesh_shape", "pert_shard_size",
    "spsa_gradient_sharded", "zo_signsgd_step_sharded",
    "make_distributed_zo_step", "make_distributed_spsa_gradient",
    "measure_collective_bytes", "wire_bound_bytes", "run_ranks",
]

PyTree = Any

PERT_AXIS = "pert"    # SPSA-perturbation sharding axis
BATCH_AXIS = "batch"  # collocation-batch sharding axis


@dataclasses.dataclass(frozen=True)
class ZOShardConfig:
    """Static layout of the distributed sweep (derived from the mesh)."""
    num_pert_shards: int = 1
    num_batch_shards: int = 1
    pert_axis: str = PERT_AXIS
    batch_axis: str = BATCH_AXIS

    @classmethod
    def from_mesh(cls, mesh: "ZOMesh") -> "ZOShardConfig":
        return cls(num_pert_shards=int(mesh.shape[PERT_AXIS]),
                   num_batch_shards=int(mesh.shape[BATCH_AXIS]))


@dataclasses.dataclass(frozen=True)
class ZOMesh:
    """This rank's place in a P×B layout of ranks.

    ``ranks`` are the world ranks of the layout, row-major: ``ranks[i·B +
    j]`` sits at pert index i and batch index j.  ``pert_group`` joins the
    P ranks of this rank's batch index, ``batch_group`` the B ranks of its
    pert index (None for an axis of size 1, and on a rank outside the
    layout)."""
    shape: dict
    ranks: tuple
    rank: int | None              # this process's world rank (None: no world)
    pert_group: Any = None
    batch_group: Any = None
    axis_names: tuple = (PERT_AXIS, BATCH_AXIS)

    @property
    def member(self) -> bool:
        return self.rank is None or self.rank in self.ranks

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def pert_index(self) -> int:
        return self._position() // self.shape[BATCH_AXIS]

    @property
    def batch_index(self) -> int:
        return self._position() % self.shape[BATCH_AXIS]

    def _position(self) -> int:
        if self.rank is None:
            return 0
        if self.rank not in self.ranks:
            raise ValueError(f"rank {self.rank} is not in this layout "
                             f"(ranks {list(self.ranks)})")
        return self.ranks.index(self.rank)


def pert_shard_size(n_total: int, n_shards: int) -> int:
    """Per-rank slice of ``n_total`` stacked losses (ceil division: the
    stack is zero-padded up to ``per * n_shards`` so every rank evaluates
    the same shape).  Floored at 2 as in the JAX package, whose XLA GEMMs
    round a unit leading dim differently; the two packages pad the same
    way."""
    if n_shards <= 1:
        return n_total
    return max(2, -(-n_total // n_shards))


def mesh_shape(spec: str | None, shard: str | None, n: int) -> tuple:
    """(P, B) of ``spec`` and ``shard`` over ``n`` ranks, with the JAX
    package's parsing and errors (``make_zo_mesh``)."""
    if shard is not None and shard not in ("perturbation", "batch", "both"):
        raise ValueError(f"unknown shard mode {shard!r}")
    if spec and "x" in spec:
        p, b = (int(v) for v in spec.split("x"))
        ok = {None: True, "perturbation": b == 1, "batch": p == 1,
              "both": True}[shard]
        if not ok:
            raise ValueError(
                f"mesh {spec} contradicts shard={shard!r} (a "
                f"{'batch' if shard == 'perturbation' else 'pert'} axis "
                f"> 1); use shard='both' for a 2-D layout")
    elif spec:
        p, b = (int(spec), 1) if shard != "batch" else (1, int(spec))
    elif shard in (None, "perturbation"):
        p, b = n, 1
    elif shard == "batch":
        p, b = 1, n
    else:  # both
        p = next(d for d in range(int(np.sqrt(n)), 0, -1) if n % d == 0)
        p, b = n // p, p
    if p * b > n:
        raise ValueError(f"mesh {p}x{b} needs {p * b} devices, have {n}")
    return p, b


def make_zo_mesh(spec: str | None = None, shard: str | None = None,
                 ranks=None) -> ZOMesh:
    """The ``("pert", "batch")`` layout over the first P·B of ``ranks``
    (default: every rank of the initialized world; without one, this
    process alone).

    ``spec`` is ``"PxB"`` or a bare count assigned to the axis ``shard``
    names; ``None`` puts all ranks on that axis; ``shard="both"`` with no
    spec takes the most balanced P×B.  A spec that contradicts ``shard``
    raises.  Rank r of the layout sits at pert index r // B and batch index
    r % B.  Every rank of the world must call this, in the same order: the
    process groups are made with ``dist.new_group``, which every rank
    enters."""
    world = dist.is_available() and dist.is_initialized()
    if ranks is None:
        ranks = range(dist.get_world_size()) if world else [0]
    ranks = [int(r) for r in ranks]
    p, b = mesh_shape(spec, shard, len(ranks))
    used = tuple(ranks[:p * b])
    rank = dist.get_rank() if world else None
    if not world and p * b > 1:
        raise ValueError(f"mesh {p}x{b} needs an initialized process group "
                         "(run the ranks with run_ranks)")
    pert_group = batch_group = None
    if world:
        # the same groups, made in the same order, on every rank
        if p > 1:
            for j in range(b):
                members = [used[i * b + j] for i in range(p)]
                g = dist.new_group(members)
                if rank in members:
                    pert_group = g
        if b > 1:
            for i in range(p):
                members = list(used[i * b:(i + 1) * b])
                g = dist.new_group(members)
                if rank in members:
                    batch_group = g
    return ZOMesh(shape={PERT_AXIS: p, BATCH_AXIS: b}, ranks=used, rank=rank,
                  pert_group=pert_group, batch_group=batch_group)


def _augmented(xis: PyTree, n: int, n_pad: int) -> PyTree:
    """The padded evaluation stack [0, ξ_1..ξ_N, 0...] of ``n_pad``
    entries: entry 0 is the base loss, the padding re-evaluates it."""
    return zoo.tree_map(
        lambda z: torch.cat([torch.zeros_like(z[:1]), z,
                             z.new_zeros((n_pad - n - 1, *z.shape[1:]))]),
        xis)


def spsa_gradient_sharded(batched_loss_fn: Callable, params: PyTree,
                          generator: torch.Generator | None,
                          xt: torch.Tensor, cfg: zoo.SPSAConfig,
                          mesh: ZOMesh, trainable_mask: PyTree | None = None,
                          xis: PyTree | None = None) -> tuple:
    """This rank's part of distributed Eq. (5). Returns (grad, base).

    ``batched_loss_fn(stacked_params, xt) -> (P,)`` evaluates a stacked
    params tree on this rank's collocation points ``xt`` (its batch shard),
    each loss a mean over them, so the mean over the batch axis is the
    global batch's loss.  ξ comes from ``generator`` (every rank seeded
    alike) or ``xis``; every rank of the layout returns the same
    gradient."""
    if cfg.antithetic:
        raise NotImplementedError(
            "antithetic SPSA is not wired through the sharded path; "
            "use the single-rank fused path (zoo.spsa_gradient)")
    n = cfg.num_samples
    shard_cfg = ZOShardConfig.from_mesh(mesh)
    npert, nbatch = shard_cfg.num_pert_shards, shard_cfg.num_batch_shards
    per = pert_shard_size(n + 1, npert)
    n_pad = per * npert
    if xis is None:
        xis = zoo.sample_perturbations(generator, params, n, trainable_mask)
    w = mesh.pert_index
    local = zoo.tree_map(lambda z: z[w * per:(w + 1) * per],
                         _augmented(xis, n, n_pad))
    lp = batched_loss_fn(
        zoo.tree_map(lambda p, z: p + cfg.mu * z.to(p.dtype), params, local),
        xt).to(torch.float32)
    if nbatch > 1:
        # the batch shards merge first: each slice becomes the full batch's
        # mean loss before the reconstruction sees it
        lp = zoo.all_reduce_sum(lp, mesh.batch_group) / nbatch
    if npert > 1:
        vec = lp.new_zeros(n_pad)
        vec[w * per:(w + 1) * per] = lp
        vec = zoo.all_reduce_sum(vec, mesh.pert_group)
    else:
        vec = lp
    base = vec[0]
    return zoo.spsa_gradient_from_losses(vec[1:n + 1], base, cfg, xis), base


def zo_signsgd_step_sharded(batched_loss_fn: Callable, params: PyTree,
                            state: zoo.ZOState, xt: torch.Tensor, lr,
                            cfg: zoo.SPSAConfig, mesh: ZOMesh,
                            trainable_mask: PyTree | None = None,
                            xis: PyTree | None = None) -> tuple:
    """One distributed Eq. (6) update on this rank, ξ drawn from
    ``counter_generator(state.seed, state.step)`` on the params' device
    (or ``xis``). Returns (params, state, base_loss), the same on every
    rank."""
    gen = None
    if xis is None:
        gen = counter_generator(state.seed, state.step,
                                device=zoo.tree_leaves(params)[0].device)
    grad, base = spsa_gradient_sharded(batched_loss_fn, params, gen, xt, cfg,
                                       mesh, trainable_mask, xis)
    return (zoo.apply_update(params, grad, lr),
            zoo.ZOState(step=state.step + 1, seed=state.seed), base)


def _batch_shard(mesh: ZOMesh, xt: torch.Tensor) -> torch.Tensor:
    nbatch = mesh.shape[BATCH_AXIS]
    if xt.shape[0] % nbatch:
        raise ValueError(f"global batch {xt.shape[0]} not divisible by the "
                         f"{nbatch}-way batch axis")
    size = xt.shape[0] // nbatch
    j = mesh.batch_index
    return xt[j * size:(j + 1) * size]


def make_distributed_zo_step(mesh: ZOMesh, batched_loss_fn: Callable,
                             cfg: zoo.SPSAConfig,
                             trainable_mask: PyTree | None = None
                             ) -> Callable:
    """This rank's distributed step over ``mesh``.

    ``batched_loss_fn(stacked_params, xt, bc) -> (P,) losses`` — e.g.
    ``lambda sp, xt, tb: pinn.residual_losses_stacked(model, sp, xt,
    noise, term_batches=tb)``.  Returns ``step(params, state, xt, bc, lr,
    xis=None) -> (params, state, loss)``: params and state replicated,
    ``xt`` the global batch (every rank takes its batch shard; its leading
    dim must divide by the batch axis), ``bc`` replicated whole (the
    boundary and data terms' rows are small and evaluated alike
    everywhere).  Rebuilding for another mesh is the whole of an elastic
    resize."""
    def step(params, state, xt, bc, lr, xis=None):
        local = _batch_shard(mesh, xt)
        return zo_signsgd_step_sharded(
            lambda sp, x: batched_loss_fn(sp, x, bc), params, state, local,
            lr, cfg, mesh, trainable_mask, xis)

    return step


def make_distributed_spsa_gradient(mesh: ZOMesh, batched_loss_fn: Callable,
                                   cfg: zoo.SPSAConfig,
                                   trainable_mask: PyTree | None = None
                                   ) -> Callable:
    """Gradient-only counterpart of ``make_distributed_zo_step``:
    ``(params, generator, xt, xis=None) -> (grad, base_loss)`` on this
    rank, with ``batched_loss_fn(stacked_params, xt)``; what the identity
    checks hold against the single-rank ``zoo.spsa_gradient`` of the same
    ξ."""
    def grad_fn(params, generator, xt, xis=None):
        return spsa_gradient_sharded(batched_loss_fn, params, generator,
                                     _batch_shard(mesh, xt), cfg, mesh,
                                     trainable_mask, xis)

    return grad_fn


def wire_bound_bytes(num_samples: int, n_pert: int, slack: int = 4) -> int:
    """The O(N)-scalar per-rank traffic budget of one distributed step:
    the sum of the zero-padded (N+1)-vector plus the batch mean of the
    local slice, all f32, plus a few scalars of slack."""
    per = pert_shard_size(num_samples + 1, n_pert)
    return 4 * (per * n_pert + per + slack)


# ------------------------------------------------------- traffic measurement

# every tensor collective of torch.distributed; the object collectives
# (all_gather_object, ...) go through these and are counted there
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "all_to_all", "all_to_all_single", "broadcast", "reduce",
                "reduce_scatter", "reduce_scatter_tensor", "gather",
                "scatter", "send", "recv", "isend", "irecv",
                "batch_isend_irecv", "barrier")


def _tensor_bytes(obj) -> tuple:
    """(bytes, shapes) of the tensors in ``obj``: a tensor, a list of
    them, or of point-to-point ops (their ``.tensor``)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size(), [tuple(obj.shape)]
    if isinstance(obj, (list, tuple)):
        total, shapes = 0, []
        for v in obj:
            b, s = _tensor_bytes(getattr(v, "tensor", v))
            total, shapes = total + b, shapes + s
        return total, shapes
    return 0, []


def measure_collective_bytes(fn: Callable, *args) -> dict:
    """This rank's bytes on the wire while ``fn(*args)`` runs: every
    ``torch.distributed`` collective it issues, through either module
    (``torch.distributed`` and ``distributed_c10d`` are both wrapped for
    the call), each counted by its first argument — the tensor reduced,
    broadcast, sent or received, or a gather's output — as the JAX
    package counts each collective's result.  A collective that a wrapped
    one issues inside itself is not counted twice.

    Returns ``{"bytes": int, "ops": [(op, shapes, bytes), ...], "result":
    fn's return value}``."""
    from torch.distributed import distributed_c10d as c10d
    ops: list = []
    depth = [0]

    def wrap(name, orig):
        def counted(*a, **k):
            if depth[0] == 0:
                first = a[0] if a else next(iter(k.values()), None)
                nbytes, shapes = _tensor_bytes(first)
                ops.append((name, shapes, nbytes))
            depth[0] += 1
            try:
                return orig(*a, **k)
            finally:
                depth[0] -= 1
        return counted

    names = [n for n in _COLLECTIVES if hasattr(c10d, n)]
    originals = {name: getattr(c10d, name) for name in names}
    saved = {(mod, name): getattr(mod, name)
             for mod in (dist, c10d) for name in names if hasattr(mod, name)}
    try:
        for (mod, name) in saved:
            setattr(mod, name, wrap(name, originals[name]))
        result = fn(*args)
    finally:
        for (mod, name), orig in saved.items():
            setattr(mod, name, orig)
    return {"bytes": sum(b for _, _, b in ops), "ops": ops, "result": result}


# ------------------------------------------------------------ the ranks

def _rank_main(rank: int, fn: Callable, world: int, init_file: str,
               out_dir: str, device_type: str, args: tuple) -> None:
    """A spawned rank: its thread count or card, the ``gloo`` world, ``fn``,
    and its result saved for the parent."""
    if device_type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args,
              device: str | torch.device = "cuda") -> list:
    """``fn(rank, world, *args)`` on ``world`` new processes joined in a
    ``gloo`` world (a ``file://`` rendezvous in a temporary directory, so
    concurrent worlds never meet).  ``device`` is checked as every entry
    point checks it (``resolve_device``: no card, no ``cuda``).  On
    ``cuda`` the ranks are spawned
    (fresh interpreters; rank r takes ``cuda:{r % device_count()}``); on
    the CPU they fork from a forkserver that imported torch once, and run
    torch on one thread each.  Either way ``fn`` must be importable by
    name (a module's top-level function) and the caller's main module is
    imported in every rank, so a script guards its ``main()``.  Returns
    each rank's return value (through ``torch.save``), in rank order; a
    rank that raises makes this raise."""
    import multiprocessing
    import torch.multiprocessing as mp
    device_type = resolve_device(device).type
    method = "spawn" if device_type == "cuda" else "forkserver"
    if method == "forkserver":
        multiprocessing.get_context(method).set_forkserver_preload(
            ["torch", __name__])
    with tempfile.TemporaryDirectory(prefix="zo_ranks_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, args=(fn, world, init_file, tmp,
                                             device_type, args),
                           nprocs=world, join=True, start_method=method)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
