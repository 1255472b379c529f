"""PyTorch/CUDA port of the tensorized, back-propagation-free optical PINN
stack (the JAX package ``repro`` is the reference it is held against).

This package imports ``torch``, numpy and the standard library only.  Its
entry points run on the GPU unless the caller asks for the CPU
(``device.resolve_device``); on a CUDA tensor every kernel wrapper launches
its hand-written Hopper kernel or raises, and only a tensor that lies on
the CPU takes the kernel's plain PyTorch version.

Layout mirrors ``repro`` module for module:

  * ``core.tt``            — TT algebra (``TTSpec``, ``tt_matvec[_stacked]``),
  * ``core.photonic``      — MZI-mesh simulator, single and stacked,
  * ``core.pinn``          — ``PINNConfig``, ``TensorPinn`` (tt / tonn) and
                             the BP-free losses, single and stacked,
  * ``core.stein``         — FD derivative estimates,
  * ``core.zoo``           — SPSA gradients and ZO-signSGD,
  * ``pde``                — the PDE registry (hjb trains, heat serves),
  * ``kernels``            — the CUDA kernels (``tt_contract``,
                             ``tt_contract_batched``,
                             ``tt_contract_batched_quant``,
                             ``mesh_apply_stacked``,
                             ``mesh_densify_stacked``, ``flash_attention``),
                             their build, plain versions and device
                             dispatch, and the block-scaled / DAC
                             quantizers (``quant``),
  * ``models``             — the LM stack: ``ModelConfig``, layers, the
                             dense decoder (forward, prefill, decode) and
                             the family-dispatched ``api``,
  * ``data``               — counter-based collocation streams,
  * ``checkpoint``         — the ``arrays.npz`` + ``meta.json`` format,
  * ``configs``            — the paper's PINN configurations
                             (``hjb_pinn``) and the ten LM architectures,
  * ``interop``            — numpy pytrees from the JAX side → tensors,
  * ``serving``            — solver registry, slot-pooled engine, cache,
  * ``launch.serve_pde``, ``launch.train``, ``launch.serve`` — the PDE
                             serving, training and LM serving entry points.
"""

from repro_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
