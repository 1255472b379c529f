"""Plain PyTorch versions of the port's kernels.

They run wherever PyTorch runs: the CPU path of ``kernels.ops`` takes them,
and on the card they are the oracle the CUDA kernels are held against.
(The plain version of the mesh kernel is ``core.photonic.mesh_apply_stacked``,
as in the JAX package.)
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import tt as tt_lib
from repro_torch.kernels import quant as quant_lib

__all__ = ["tt_contract_ref", "split_batch_axes", "tt_contract_batched_ref",
           "tt_contract_batched_quant_ref"]


def tt_contract_ref(x: torch.Tensor, cores: Sequence[torch.Tensor],
                    spec: tt_lib.TTSpec) -> torch.Tensor:
    """y = x @ W(cores)^T via the chain contraction (never densifies W)."""
    return tt_lib.tt_matvec(cores, x, spec)


def split_batch_axes(x: torch.Tensor, P: int, spec: tt_lib.TTSpec,
                     shared_x: bool | None) -> tuple:
    """Resolve ``shared_x`` and flatten extra batch axes, as the TPU
    kernel's ``_split_batch_axes`` does: ``None`` infers shared for a 2-D
    x and per-entry (leading P axis) otherwise.  Returns
    ``(xf, batch_shape, shared)`` with xf ``(B, N)`` or ``(P, B, N)``."""
    if shared_x is None:
        shared_x = x.ndim == 2
    if shared_x:
        return x.reshape(-1, spec.in_dim), tuple(x.shape[:-1]), True
    if x.shape[0] != P:
        raise ValueError(f"x leading axis {x.shape[0]} != core stack P={P}")
    return x.reshape(P, -1, spec.in_dim), tuple(x.shape[1:-1]), False


def tt_contract_batched_ref(x: torch.Tensor, cores: Sequence[torch.Tensor],
                            spec: tt_lib.TTSpec,
                            shared_x: bool | None = None) -> torch.Tensor:
    """Plain version of the multi-perturbation kernel: the stacked chain
    over the leading core-stack axis, x shared ``(..., N)`` or per entry
    ``(P, ..., N)``; extra batch axes flatten and come back on the
    output ``(P, *batch_axes, M)``."""
    P = cores[0].shape[0]
    xf, batch_shape, _ = split_batch_axes(x, P, spec, shared_x)
    y = tt_lib.tt_matvec_stacked(cores, xf, spec)
    return y.reshape(P, *batch_shape, spec.out_dim)


def tt_contract_batched_quant_ref(x: torch.Tensor,
                                  cores: Sequence[torch.Tensor],
                                  spec: tt_lib.TTSpec,
                                  quant: quant_lib.QuantConfig,
                                  shared_x: bool | None = None
                                  ) -> torch.Tensor:
    """Plain version of ``tt_contract.tt_contract_batched_quant``: each of
    the P core variants fake-quantized with its own block scales, then the
    stacked f32 chain; x and the output as in
    ``tt_contract_batched_ref``."""
    fq = [quant_lib.fake_quant_stacked(c, quant) for c in cores]
    return tt_contract_batched_ref(x, fq, spec, shared_x)
