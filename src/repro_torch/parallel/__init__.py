"""Distributed BP-free ZO training over ``torch.distributed``
(``zo_shard``)."""

from repro_torch.parallel.zo_shard import (  # noqa: F401
    BATCH_AXIS, PERT_AXIS, ZOMesh, ZOShardConfig, make_distributed_spsa_gradient,
    make_distributed_zo_step, make_zo_mesh, measure_collective_bytes, mesh_shape,
    pert_shard_size, run_ranks, spsa_gradient_sharded, wire_bound_bytes,
    zo_signsgd_step_sharded)
