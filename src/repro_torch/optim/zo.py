"""BP-free trainer steps: ZO-signSGD for any model whose loss is only ever
evaluated forward.

``distributed_zo_signsgd_step`` builds the distributed step of
``repro_torch.parallel.zo_shard`` for a ``("pert", "batch")`` layout of
ranks: perturbation and/or collocation-batch sharding, O(N) scalars on
the wire a step, the same update as ``zoo.zo_signsgd_step``.

``zo_signsgd_trainer_step`` is the single-axis building block: with
``num_workers > 1`` each worker evaluates its contiguous slice of the N
perturbations (``zoo.spsa_gradient``'s ``index_shard``) and one
``all_reduce`` over ``group`` merges the N-vector of losses.

Port of ``repro.optim.zo``; ``vectorized=True`` (the generic batched
evaluator) waits for ROADMAP item 14a.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import zoo

__all__ = ["distributed_zo_signsgd_step", "zo_signsgd_trainer_step"]

PyTree = Any


def distributed_zo_signsgd_step(mesh, batched_loss_fn: Callable,
                                num_samples: int = 10, mu: float = 1e-2,
                                trainable_mask: PyTree | None = None
                                ) -> Callable:
    """The distributed ZO-signSGD step of this rank for ``mesh``
    (``zo_shard.make_zo_mesh``): ``batched_loss_fn(stacked_params, xt, bc)
    -> (P,) losses`` on this rank's batch shard, e.g. the PINN's fused
    ``residual_losses_stacked``.  Returns ``step(params, state, xt, bc, lr,
    xis=None) -> (params, state, loss)``; rebuild it for another mesh to
    resize (``repro_torch.runtime.ZOElasticController``).
    ``trainable_mask`` keeps fixed buffers out of the probe and the
    update."""
    from repro_torch.parallel import zo_shard
    cfg = zoo.SPSAConfig(num_samples=num_samples, mu=mu)
    return zo_shard.make_distributed_zo_step(mesh, batched_loss_fn, cfg,
                                             trainable_mask=trainable_mask)


def zo_signsgd_trainer_step(loss_fn: Callable[[PyTree], torch.Tensor] | None,
                            params: PyTree, generator: torch.Generator,
                            lr: float, num_samples: int = 10,
                            mu: float = 1e-2, group=None,
                            worker_index: int = 0, num_workers: int = 1,
                            vectorized: bool = False,
                            batched_loss_fn: Callable | None = None,
                            trainable_mask: PyTree | None = None) -> tuple:
    """One BP-free update Φ − lr · sign(ĝ). Returns ``(new_params, loss)``.

    ``generator`` draws ξ (every worker seeds it alike).
    ``batched_loss_fn`` evaluates a stacked params tree in one program.
    With ``num_workers > 1`` worker ``worker_index`` evaluates its slice of
    the N losses, and with a process ``group`` (``dist.group.WORLD`` for
    the whole world) the slices are summed over its ranks, so every worker
    returns the same params; without one the other slices stay zero, as
    in the JAX package without an ``axis_name``."""
    if vectorized:
        raise NotImplementedError(
            "vectorized=True (the generic batched evaluator) is not ported "
            "yet (ROADMAP queue A, item 14a); pass batched_loss_fn")
    cfg = zoo.SPSAConfig(num_samples=num_samples, mu=mu)
    shard = None
    if num_workers > 1:
        per = -(-num_samples // num_workers)
        shard = (worker_index * per,
                 min(num_samples, (worker_index + 1) * per))
    grad, base = zoo.spsa_gradient(params, generator, cfg, batched_loss_fn,
                                   trainable_mask, loss_fn=loss_fn,
                                   index_shard=shard, group=group)
    return zoo.apply_update(params, grad, lr), base
