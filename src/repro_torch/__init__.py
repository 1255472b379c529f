"""PyTorch/CUDA port of the tensorized, back-propagation-free optical PINN
stack (the JAX package ``repro`` is the reference it is held against).

This package imports ``torch``, numpy and the standard library only.  Its
entry points run on the GPU unless the caller asks for the CPU
(``device.resolve_device``); on a CUDA tensor every kernel wrapper launches
its hand-written Hopper kernel or raises, and only a tensor that lies on
the CPU takes the kernel's plain PyTorch version.

Layout mirrors ``repro`` module for module:

  * ``core.tt``            — TT algebra (``TTSpec``, ``tt_matvec``, ...),
  * ``core.photonic``      — MZI-mesh simulator for load-time densification,
  * ``core.pinn``          — ``PINNConfig`` and ``TensorPinn`` (tt / tonn),
  * ``pde``                — the serving surface of the PDE registry,
  * ``kernels``            — the CUDA ``tt_contract`` kernel, its build,
                             its plain version and the device dispatch,
  * ``checkpoint``         — the ``arrays.npz`` + ``meta.json`` format,
  * ``interop``            — numpy pytrees from the JAX side → tensors,
  * ``serving``            — solver registry, slot-pooled engine, cache,
  * ``launch.serve_pde``   — the serving CLI.
"""

from repro_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
