"""PDE solver-as-a-service on the GPU: the batched inference runtime for
trained ``TensorPinn`` solvers (port of ``repro.serving``).

  * ``SolverRegistry`` / ``LoadedSolver`` — named solvers made
    inference-ready once (TONN densification, chip noise baked in),
  * ``PdeServingEngine`` / ``PointRequest`` — slot-pooled continuous
    batching with one shape-stable program per (solver, dtype, slot-shape),
  * ``StencilCache`` — LRU result cache on quantized query coordinates.

Quickstart::

    from repro_torch.serving import (PdeServingEngine, PointRequest,
                                     SolverRegistry)
    reg = SolverRegistry()                      # device="cuda"
    reg.load_checkpoint("heat", "ckpts/heat-10d")
    eng = PdeServingEngine(reg, slots=8, slot_points=256)
    req = eng.submit(PointRequest("heat", points))  # (n, in_dim) queries
    eng.run()
    req.out                                         # (n,) u-values
"""

from repro_torch.serving.cache import StencilCache  # noqa: F401
from repro_torch.serving.engine import PdeServingEngine, PointRequest  # noqa: F401
from repro_torch.serving.registry import LoadedSolver, SolverRegistry  # noqa: F401

__all__ = ["StencilCache", "PdeServingEngine", "PointRequest",
           "LoadedSolver", "SolverRegistry"]
