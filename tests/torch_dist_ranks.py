"""What each rank of the distribution tests' world runs.

A module of its own, with no JAX import, so that the spawned ranks import
it by name (``zo_shard.run_ranks`` pickles the function by reference) at
the cost of torch and the port alone.  ``world_cases`` runs every case of
``tests/test_torch_distribution.py`` in one 8-rank world and returns this
rank's results as numpy; the tests compare them with the single-rank
references computed in the test process.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import pinn as tpinn
from repro_torch.core import zoo
from repro_torch.device import counter_generator
from repro_torch.optim import zo_signsgd_trainer_step
from repro_torch.parallel import zo_shard
from repro_torch.runtime import ZOElasticController

# 1, 2 and 8 ranks; perturbation, batch and both axes.  N = 6 makes 7
# stacked losses, which 2, 4 and 8 do not divide: the padded slices run.
ZO_LAYOUTS = [("1x1", "perturbation"), ("2x1", "perturbation"),
              ("8x1", "perturbation"), ("1x2", "batch"), ("1x8", "batch"),
              ("2x2", "both"), ("4x2", "both"), ("2x4", "both")]

QUAD_SEED = 3         # the quadratic case's ξ generator
PINN_SEED = 5         # the PINN case's own ξ generator


def numpy_tree(tree):
    return zoo.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def quad_batched_loss(target: torch.Tensor):
    def blf(sp, xt):
        d = (sp["w"][:, None, :] - target[None, None, :]
             + 0.0 * xt[None, :, :1])
        return torch.mean(torch.sum(d * d, dim=-1), dim=-1)
    return blf


def quad_loss(target: torch.Tensor):
    return lambda p: torch.sum((p["w"] - target) ** 2)


def pinn_setup(inputs: dict) -> tuple:
    """The port's model, params, batch, SPSA config and stacked loss of
    the PINN case, from the arrays the JAX side made."""
    model = tpinn.TensorPinn(tpinn.config_from_meta(inputs["pinn_meta"]))
    params = interop.params_from_numpy(inputs["pinn_params"], "cpu")
    xt = torch.tensor(inputs["pinn_xt"])
    cfg = zoo.SPSAConfig(num_samples=inputs["pinn_n"], mu=1e-2)

    def blf(sp, x):
        return tpinn.residual_losses_stacked(model, sp, x)

    return model, params, xt, cfg, blf


def pinn_u_loss(model):
    """A u-level functional of the PINN, mean over the points of (u −
    mean(x))²: the same stacked chain and densification as the residual,
    no FD stencil (whose second differences amplify the two packages'
    f32 rounding of u by 1/h²); a mean, so the batch axis can shard it."""
    def blf(sp, x):
        u = model.u_stacked(model.prepare_params_stacked(sp, None), x)
        return torch.mean((u - x.mean(dim=-1)) ** 2, dim=-1)
    return blf


def _masked_protocol(rank: int, world: int, inputs: dict) -> dict:
    """The scalar-only protocol by hand: every rank evaluates all N losses
    from the shared generator, keeps its own index, and one all_reduce of
    the N-vector merges them; then ``optim.zo_signsgd_trainer_step`` over
    the index-shard hook, a slice a worker."""
    target = torch.tensor(inputs["mask_target"])
    loss_fn = quad_loss(target)
    params = {"w": torch.zeros(16)}
    cfg = zoo.SPSAConfig(num_samples=world, mu=1e-2)
    xis = zoo.sample_perturbations(counter_generator(QUAD_SEED), params,
                                   cfg.num_samples)
    losses = zoo.spsa_losses(loss_fn, params, None, cfg, xis=xis)
    mask = (torch.arange(cfg.num_samples) == rank).to(losses.dtype)
    merged = zoo.all_reduce_sum(losses * mask, dist.group.WORLD)
    g = zoo.spsa_gradient_from_losses(merged, loss_fn(params), cfg, xis)
    sliced = zoo.spsa_losses(loss_fn, params, None, cfg, xis=xis,
                             index_shard=(rank, rank + 1))
    new_params, base = zo_signsgd_trainer_step(
        loss_fn, params, counter_generator(QUAD_SEED), 1e-3,
        num_samples=world, group=dist.group.WORLD, worker_index=rank,
        num_workers=world)
    return {"grad": g["w"].numpy(), "sliced": sliced.numpy(),
            "trainer_params": new_params["w"].numpy(),
            "trainer_loss": float(base)}


def _layouts(inputs: dict) -> dict:
    """Every layout's distributed gradient, for the quadratic loss (ξ from
    ``QUAD_SEED``) and the PINN (ξ from ``PINN_SEED`` and JAX's ξ)."""
    target = torch.tensor(inputs["quad_target"])
    quad_xt = torch.tensor(inputs["quad_xt"])
    quad_params = {"w": torch.zeros(16)}
    quad_cfg = zoo.SPSAConfig(num_samples=6, mu=1e-2)
    model, params, xt, cfg, blf = pinn_setup(inputs)
    mask = model.trainable_mask(params)
    jax_xis = interop.params_from_numpy(inputs["pinn_jax_xis"], "cpu")
    out = {}
    for spec, shard in ZO_LAYOUTS:
        mesh = zo_shard.make_zo_mesh(spec, shard)
        if not mesh.member:
            continue
        row = {"position": (mesh.pert_index, mesh.batch_index)}
        g, base = zo_shard.make_distributed_spsa_gradient(
            mesh, quad_batched_loss(target), quad_cfg)(
            quad_params, counter_generator(QUAD_SEED), quad_xt)
        row["quad"] = (g["w"].numpy(), float(base))
        grad_fn = zo_shard.make_distributed_spsa_gradient(mesh, blf, cfg,
                                                          trainable_mask=mask)
        g, base = grad_fn(params, counter_generator(PINN_SEED), xt)
        row["pinn"] = (numpy_tree(g), float(base))
        g, base = grad_fn(params, None, xt, xis=jax_xis)
        row["pinn_jax_xis"] = (numpy_tree(g), float(base))
        g, base = zo_shard.make_distributed_spsa_gradient(
            mesh, pinn_u_loss(model), cfg, trainable_mask=mask)(
            params, None, xt, xis=jax_xis)
        row["pinn_u_jax_xis"] = (numpy_tree(g), float(base))
        out[spec] = row
    return out


def _traffic(inputs: dict) -> dict:
    """Bytes on the wire of one distributed PINN step on the 4x2 layout,
    every collective counted."""
    model, params, xt, cfg, blf = pinn_setup(inputs)
    mesh = zo_shard.make_zo_mesh("4x2", "both")
    step = zo_shard.make_distributed_zo_step(
        mesh, lambda sp, x, bc: blf(sp, x), cfg,
        trainable_mask=model.trainable_mask(params))
    traffic = zo_shard.measure_collective_bytes(
        step, params, zoo.ZOState(step=0, seed=0), xt, None, 1e-3)
    def others():
        dist.all_reduce(torch.ones(3))
        dist.broadcast(torch.zeros(5, dtype=torch.float64), src=0)
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, {"rank": dist.get_rank()})
        return got

    counted = zo_shard.measure_collective_bytes(others)
    return {"bytes": traffic["bytes"],
            "ops": [(op, shapes, b) for op, shapes, b in traffic["ops"]],
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in zoo.tree_leaves(params)),
            "others": counted["ops"], "gathered": counted["result"]}


def _elastic(rank: int, inputs: dict) -> dict:
    """Checkpoint on 8 ranks, resume on 4: the 8-rank run's losses and
    params, and the resumed run's (rank 0 writes; ranks 4–7 sit the
    resumed steps out)."""
    model, params, xt, cfg, blf = pinn_setup(inputs)
    mask = model.trainable_mask(params)
    state = zoo.ZOState(step=0, seed=7)

    def make_mesh(n):
        return zo_shard.make_zo_mesh(str(n), "perturbation", ranks=range(n))

    def build(mesh):
        return zo_shard.make_distributed_zo_step(
            mesh, lambda sp, x, bc: blf(sp, x), cfg, trainable_mask=mask)

    ckpt = CheckpointManager(inputs["ckpt_dir"], keep=2, save_every=1)
    ctl = ZOElasticController(ckpt=ckpt, make_mesh=make_mesh,
                              build_step=build)
    step8 = build(make_mesh(8))
    losses8 = []
    for _ in range(2):
        params, state, loss = step8(params, state, xt, None, 1e-3)
        losses8.append(float(loss))
    if rank == 0:
        ckpt.save(2, {"params": params, "zo": state.as_tree()}, {"step": 2})
    dist.barrier()
    p_ref, s_ref = params, state
    for _ in range(3):
        p_ref, s_ref, loss = step8(p_ref, s_ref, xt, None, 1e-3)
        losses8.append(float(loss))

    like = {"params": zoo.tree_map(torch.zeros_like, params),
            "zo": zoo.ZOState().as_tree()}
    mesh4, step4, tree, meta = ctl.resume(4, like)
    out = {"losses8": losses8, "meta_step": meta["step"],
           "pert4": mesh4.shape["pert"], "member4": mesh4.member}
    if mesh4.member:
        p4, s4 = tree["params"], zoo.ZOState.from_tree(tree["zo"])
        losses4 = []
        for _ in range(3):
            p4, s4, loss = step4(p4, s4, xt, None, 1e-3)
            losses4.append(float(loss))
        out.update(losses4=losses4, params4=numpy_tree(p4),
                   params_ref=numpy_tree(p_ref), step4=s4.step)
    return out


def world_cases(rank: int, world: int, inputs: dict) -> dict:
    """Every case of the distribution tests on this rank of one world."""
    return {"rank": rank, "world": world,
            "masked": _masked_protocol(rank, world, inputs),
            "layouts": _layouts(inputs),
            "traffic": _traffic(inputs),
            "elastic": _elastic(rank, inputs)}


def failing_rank(rank: int, world: int) -> None:
    """Rank 1 raises: the launcher must raise in the parent."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
