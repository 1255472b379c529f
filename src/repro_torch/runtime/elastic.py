"""Elastic resizing of distributed ZO training.

Distributed ZO (``repro_torch.parallel.zo_shard``) replicates the
parameters: it shards work — perturbation slices and collocation batches —
never state.  So a change of the world's size needs no re-sharding: take
the newest checkpoint, rebuild the layout over the surviving ranks and the
step for it (the perturbation slices re-resolve from the new ``"pert"``
size), and resume.  The gradient does not depend on the layout, so the
run continues as if the world had never changed (tested 8 → 4 ranks in
``tests/test_torch_distribution.py``).

Port of ``ZOElasticController`` from ``repro.runtime.elastic``.  The BP
controller there, ``ElasticController``, re-places sharded LM parameters
on a new device mesh; it waits for the port of the mesh sharding rules and
the remesh pass (ROADMAP queue A, item 14f).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.checkpoint import CheckpointManager

__all__ = ["ZOElasticController"]

PyTree = Any


@dataclasses.dataclass
class ZOElasticController:
    """Elastic controller for distributed ZO training (replicated params).

    ``make_mesh(n)`` builds the ``("pert", "batch")`` layout over the first
    n ranks (e.g. ``lambda n: zo_shard.make_zo_mesh(str(n), ranks=range(n))``;
    every rank of the world calls it, since it makes process groups) and
    ``build_step(mesh)`` the step for it
    (``zo_shard.make_distributed_zo_step``)."""
    ckpt: CheckpointManager
    make_mesh: Callable[[int], Any]
    build_step: Callable[[Any], Callable]

    def resume(self, n_ranks: int, tree_like: PyTree) -> tuple:
        """Rebuild on ``n_ranks``; returns (mesh, step_fn, tree, meta).

        ``tree_like`` matches what the trainer checkpoints, e.g.
        ``{"params": params, "zo": state.as_tree()}``; the restored tree
        has its template's dtypes and devices.  Raises
        ``FileNotFoundError`` without a complete checkpoint."""
        mesh = self.make_mesh(n_ranks)
        tree, meta = self.ckpt.restore_latest(tree_like)
        return mesh, self.build_step(mesh), tree, meta
