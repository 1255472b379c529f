"""Block-scaled quantization of the TT cores and DAC quantization of the phases.

Two domains, as in the JAX package (``repro.kernels.quant``):

  * **Weights (TT cores)** — per-block absmax scaling of the flattened core
    to int8 or fp8-e4m3: each run of ``block`` elements shares one f32
    scale (``absmax / qmax``), the values are stored in the narrow type and
    every consumer dequantizes to f32 before the contraction.  Storage at
    block 32: 1 + 4/32 = 1.125 bytes per parameter.
  * **Phases (DAC)** — the commanded MZI phases snap to the uniform
    ``2π / 2**phase_bits`` grid before the hardware noise model acts.

``fake_quant`` (quantize, then dequantize) is the plain version of what the
quantized CUDA kernel sees: the kernel quantizes the f32 cores on chip, run
by run, with the operations of ``quantize_blockwise_stacked`` and
``dequantize_blockwise_stacked`` in their order, each rounded on its own,
so it reads the same core values bit for bit.  Both schemes are idempotent.
Every division here divides by a tensor, never by a Python number: on a
CUDA tensor PyTorch turns ``t / number`` into ``t * (1 / number)``, which
rounds differently, and the codes made on the card must equal the CPU's
and the kernel's.

Port of ``repro.kernels.quant``; the stacked forms replace its ``vmap``.
With ``QuantConfig.enabled`` False every hook takes the unquantized path.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["QuantConfig", "QUANT_DTYPES", "quantize_blockwise",
           "quantize_blockwise_stacked", "dequantize_blockwise",
           "dequantize_blockwise_stacked", "fake_quant", "fake_quant_stacked",
           "quantize_phases", "quantized_bytes_per_param"]

# narrow storage type → (torch dtype, qmax of the absmax scale)
QUANT_DTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
}


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization settings of a ``PINNConfig``.

    ``enabled`` gates everything.  ``dtype`` is the weight storage format
    (None keeps the weights f32, e.g. phase quantization alone), ``block``
    the absmax-scaling granularity over the flattened core, ``phase_bits``
    the DAC resolution of the trainable MZI phases (None: analog phases).
    """

    enabled: bool = False
    dtype: str | None = "int8"      # "int8" | "fp8_e4m3" | None
    block: int = 32
    phase_bits: int | None = None

    def __post_init__(self):
        if self.dtype is not None and self.dtype not in QUANT_DTYPES:
            raise ValueError(
                f"unknown quant dtype {self.dtype!r}; "
                f"allowed: {sorted(QUANT_DTYPES)} or None")
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")
        if self.phase_bits is not None and not 1 <= self.phase_bits <= 32:
            raise ValueError(f"phase_bits must be in [1, 32], "
                             f"got {self.phase_bits}")

    @property
    def weights(self) -> bool:
        """True iff TT-core quantization is on."""
        return self.enabled and self.dtype is not None

    @property
    def phases(self) -> bool:
        """True iff DAC phase quantization is on."""
        return self.enabled and self.phase_bits is not None

    def tag(self) -> str:
        """Short canonical string for program and cache keys; empty when
        off, so the unquantized key formats stay as they were."""
        if not self.enabled:
            return ""
        parts = []
        if self.dtype is not None:
            parts.append(f"{self.dtype}b{self.block}")
        if self.phase_bits is not None:
            parts.append(f"pb{self.phase_bits}")
        return "+".join(parts) if parts else "noop"


def _check_weights(cfg: QuantConfig) -> tuple:
    if not cfg.weights:
        raise ValueError(f"weight quantization not enabled in {cfg}")
    return QUANT_DTYPES[cfg.dtype]


def quantize_blockwise_stacked(x: torch.Tensor, cfg: QuantConfig) -> tuple:
    """Quantize each of the P rows of ``x (P, ...)`` on its own, with
    per-block absmax scaling over the row's flattened elements.

    Returns ``(q, scales)``: ``q (P, padded)`` in the narrow type (each row
    zero-padded to a ``cfg.block`` multiple), ``scales (P, padded // block)``
    f32.  An all-zero block gets scale 1.0.
    """
    qdtype, qmax = _check_weights(cfg)
    P = x.shape[0]
    flat = x.reshape(P, -1).to(torch.float32)
    n = flat.shape[1]
    padded = -(-n // cfg.block) * cfg.block
    if padded != n:
        flat = torch.nn.functional.pad(flat, (0, padded - n))
    blocks = flat.reshape(P, -1, cfg.block)
    absmax = blocks.abs().amax(dim=-1)
    scales = torch.where(absmax > 0, absmax / torch.full_like(absmax, qmax),
                         torch.ones_like(absmax))
    scaled = blocks / scales[..., None]
    if cfg.dtype == "int8":
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(qdtype)
    else:
        q = scaled.to(qdtype)
    return q.reshape(P, padded), scales


def quantize_blockwise(x: torch.Tensor, cfg: QuantConfig) -> tuple:
    """``quantize_blockwise_stacked`` of one tensor of any shape: ``q``
    flat ``(padded,)`` and ``scales (padded // block,)``."""
    q, scales = quantize_blockwise_stacked(x.reshape(1, -1), cfg)
    return q[0], scales[0]


def dequantize_blockwise_stacked(q: torch.Tensor, scales: torch.Tensor,
                                 shape: tuple,
                                 cfg: QuantConfig) -> torch.Tensor:
    """Inverse of ``quantize_blockwise_stacked``: f32 ``(P, *shape)``,
    contiguous (the kernels take only contiguous cores)."""
    _check_weights(cfg)
    P = q.shape[0]
    deq = q.reshape(P, -1, cfg.block).to(torch.float32) * scales[..., None]
    return deq.reshape(P, -1)[:, :math.prod(shape)].contiguous().reshape(
        P, *shape)


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor, shape: tuple,
                         cfg: QuantConfig) -> torch.Tensor:
    """Inverse of ``quantize_blockwise``: f32 tensor of ``shape``."""
    return dequantize_blockwise_stacked(q[None], scales[None], tuple(shape),
                                        cfg)[0]


def fake_quant_stacked(x: torch.Tensor, cfg: QuantConfig | None) -> torch.Tensor:
    """``fake_quant`` of each of the P rows of ``x (P, ...)`` with its own
    block scales — the values the quantized kernel gives its cores."""
    if not (cfg and cfg.weights):
        return x
    q, scales = quantize_blockwise_stacked(x, cfg)
    return dequantize_blockwise_stacked(q, scales, tuple(x.shape[1:]),
                                        cfg).to(x.dtype)


def fake_quant(x: torch.Tensor, cfg: QuantConfig | None) -> torch.Tensor:
    """Quantize → dequantize round trip (the QAT semantics).  Passes ``x``
    through when weight quantization is off.  Idempotent: the absmax
    element of each block maps back onto itself."""
    if not (cfg and cfg.weights):
        return x
    return fake_quant_stacked(x[None], cfg)[0]


def quantize_phases(phases: torch.Tensor, bits: int) -> torch.Tensor:
    """Snap phases to the uniform ``2π / 2**bits`` DAC grid (round to the
    nearest code).  Idempotent; keeps the dtype."""
    step = torch.full_like(phases, 2.0 * math.pi / (1 << bits))
    return (torch.round(phases / step) * step).to(phases.dtype)


def quantized_bytes_per_param(cfg: QuantConfig) -> float:
    """Storage cost of the block-scaled format in bytes per parameter: one
    narrow byte per value and one f32 scale per block."""
    if not cfg.weights:
        return 4.0
    return 1.0 + 4.0 / cfg.block
