"""Plain PyTorch versions of the port's kernels.

They run wherever PyTorch runs: the CPU path of ``kernels.ops`` takes them,
and on the card they are the oracle the CUDA kernels are held against.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import tt as tt_lib

__all__ = ["tt_contract_ref"]


def tt_contract_ref(x: torch.Tensor, cores: Sequence[torch.Tensor],
                    spec: tt_lib.TTSpec) -> torch.Tensor:
    """y = x @ W(cores)^T via the chain contraction (never densifies W)."""
    return tt_lib.tt_matvec(cores, x, spec)
