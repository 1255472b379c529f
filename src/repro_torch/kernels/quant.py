"""Quantization settings of a ``PINNConfig`` — the fields only.

Port of ``repro.kernels.quant.QuantConfig`` so that checkpoint meta
round-trips; quantized serving is not ported yet, and the serving
registry refuses configs with ``enabled`` set.
"""

from __future__ import annotations

import dataclasses

__all__ = ["QuantConfig"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    enabled: bool = False
    dtype: str | None = "int8"      # "int8" | "fp8_e4m3" | None
    block: int = 32
    phase_bits: int | None = None
