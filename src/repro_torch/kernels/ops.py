"""Entry points of the port's kernels, dispatched on the tensor's device.

A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel, which raises on anything it cannot take.
There is no switch that sends CUDA tensors to the plain version.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import tt as tt_lib
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tt_contract as _ttc

__all__ = ["tt_linear"]


def tt_linear(x: torch.Tensor, cores: Sequence[torch.Tensor],
              spec: tt_lib.TTSpec) -> torch.Tensor:
    """``y = x @ W(cores)^T``: x (..., N) → (..., M)."""
    if x.device.type == "cpu":
        return _ref.tt_contract_ref(x, cores, spec)
    return _ttc.tt_contract(x, cores, spec)
