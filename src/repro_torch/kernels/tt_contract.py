"""Wrappers of the hand-written CUDA TT-chain kernels (``csrc/tt_contract.cu``).

Replace the Pallas kernels ``repro/kernels/tt_contract.py::tt_contract``
(its ``pallas_call`` at line 115), ``::tt_contract_batched`` (line 212) and
``::tt_contract_batched_quant`` (line 300): ``y = x @ W(cores)^T`` with the
whole chain kept on chip for one tile of rows, for one core set or for P
stacked ones (the SPSA perturbations of a ZO step) in one launch over a
(row tile, P) grid; the quantized kernel reads each entry's f32 cores and
block-quantizes them to int8 or fp8-e4m3 on chip.

Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32 without tensor cores): at the
paper's 1024×1024 spec a row moves 8 KB and costs 64 KFLOP, so the kernels
are memory-bound — about 5 µs for the served pool of 2048 rows and 116 µs
for the 11 × 4300 rows of the training hidden layer.  The design keeps
every intermediate in shared memory, so device memory sees only the input,
the output and the tiny cores; see the source for the chain layout.  All
three kernels run one body (a thread per fiber, the step's core in
registers, tiles of ``fiber_tile``), which gives every output element the
same sum in the same order, so they agree bit for bit.

The wrappers check what the kernels take and raise on anything else; they
never fall back to the plain versions.  They allocate the output, launch
on the current stream without synchronizing, and count their launches in
``tt_contract.launches``, ``tt_contract_batched.launches`` and
``tt_contract_batched_quant.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import tt as tt_lib
from repro_torch.kernels import _build
from repro_torch.kernels import quant as quant_lib
from repro_torch.kernels import ref as _ref

__all__ = ["tt_contract", "tt_contract_batched", "tt_contract_batched_quant",
           "chain_widest", "fiber_tile", "FiberTile"]

MAX_CORES = 8                      # kMaxCores in the source
SMEM_MAX_BYTES = 232_448           # Hopper's per-block opt-in maximum


def chain_widest(spec: tt_lib.TTSpec) -> int:
    """Widest intermediate along the chain, in floats per row (at least the
    input and output widths) — as ``default_batch_tile`` of the TPU kernel
    reckons it."""
    widest = max(spec.in_dim, spec.out_dim)
    m_prefix, n_suffix = 1, spec.in_dim
    for r, m_k, n_k, r_next in spec.core_shapes:
        n_suffix //= n_k
        widest = max(widest, m_prefix * m_k * r_next * n_suffix)
        m_prefix *= m_k
    return widest


def _core_floats(spec: tt_lib.TTSpec) -> int:
    return (spec.num_params + 3) // 4 * 4


# the fiber body
FIBER_THREADS = 128                # kFiberThreads in the source
MAX_FIBER = 32                     # kMaxFiber: widest r·n_k or m_k·r'
MAX_FIBER_ROWS = 32
# three blocks share one SM (164 registers a thread, __launch_bounds__(128,
# 3)): 228 KB of shared memory a Hopper SM, 1 KB of it reserved per block
BLOCKS_PER_SM = 3
SMEM_BLOCK_BUDGET = 228 * 1024 // BLOCKS_PER_SM - 1024
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class FiberTile:
    """A launch of the fiber body: ``rows`` per block, row buffers of
    ``stride`` floats (one buffer when every step writes in place, two
    otherwise), the template width of each step and the dynamic shared
    memory, as ``parse_fibers`` in the source lays them out."""
    rows: int
    stride: int
    buffers: int
    caps: tuple
    smem_bytes: int


def fiber_tile(spec: tt_lib.TTSpec,
               rows_total: int | None = None) -> FiberTile:
    """Tiling of the fiber body for ``spec``: as many rows per block as let
    three blocks share an SM (at most 32, a multiple of 8 from 8 up), and
    no more than give ``rows_total`` rows (the launch's P·B) three blocks on
    each of the H100's SMs.  Raises for a fiber wider than ``MAX_FIBER`` and
    for a row that does not fit a block: there is no other body to fall
    back to."""
    widths = [(r * n, m * rn) for r, m, n, rn in spec.core_shapes]
    if max(max(w) for w in widths) > MAX_FIBER:
        raise ValueError(f"TT chain of {spec} has fibers of (r·n_k, m_k·r') "
                         f"= {widths}; the kernel takes at most {MAX_FIBER}")
    caps = tuple(max(4, 1 << (max(w) - 1).bit_length()) for w in widths)
    stride = -(-chain_widest(spec) // 32) * 32
    buffers = 1 if all(f_in == f_out for f_in, f_out in widths) else 2
    fixed = 4 * (_core_floats(spec) + sum(c * c for c in caps))
    per_row = 4 * buffers * stride
    rows = min(MAX_FIBER_ROWS, (SMEM_BLOCK_BUDGET - fixed) // per_row)
    if rows >= 8:
        rows -= rows % 8
    elif rows < 1:
        if fixed + per_row > SMEM_MAX_BYTES:
            raise ValueError(f"TT chain of {spec} needs {fixed + per_row} B "
                             f"of shared memory per row; the card has "
                             f"{SMEM_MAX_BYTES} B per block")
        rows = 1
    if rows_total is not None:
        fill = -(-rows_total // (BLOCKS_PER_SM * H100_SMS))
        rows = max(1, min(rows, fill))
    return FiberTile(rows, stride, buffers, caps, fixed + rows * per_row)


@functools.cache
def _launchers():
    lib = _build.load_library("tt_contract")
    single = lib.tt_contract_launch
    single.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    batched = lib.tt_contract_batched_launch
    batched.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_int, ctypes.c_void_p]
    quant = lib.tt_contract_batched_quant_launch
    quant.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p]
    for fn in (single, batched, quant):
        fn.restype = ctypes.c_int
    return single, batched, quant


def _check_x(name: str, x: torch.Tensor, spec: tt_lib.TTSpec) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {x.dtype}")
    if x.ndim < 1 or x.shape[-1] != spec.in_dim:
        raise ValueError(f"x shape {tuple(x.shape)} does not end in "
                         f"in_dim={spec.in_dim}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous x")


def _check_cores(cores: Sequence[torch.Tensor], spec: tt_lib.TTSpec,
                 device: torch.device, stack: tuple = ()) -> None:
    """Each core a contiguous float32 ``(*stack, r, m, n, r')`` on
    ``device``."""
    if not 1 <= spec.L <= MAX_CORES or len(cores) != spec.L:
        raise ValueError(f"need 1..{MAX_CORES} cores matching the spec, "
                         f"got {len(cores)} for L={spec.L}")
    for k, (c, shape) in enumerate(zip(cores, spec.core_shapes)):
        shape = (*stack, *shape)
        if (c.device != device or c.dtype != torch.float32
                or tuple(c.shape) != shape or not c.is_contiguous()):
            raise ValueError(
                f"core {k}: need a contiguous float32 {shape} tensor on "
                f"{device}, got {c.dtype} {tuple(c.shape)} on {c.device}")


def _descriptor(cores: Sequence[torch.Tensor], spec: tt_lib.TTSpec):
    return np.asarray([spec.L, chain_widest(spec), *spec.out_modes,
                       *spec.in_modes, *spec.ranks,
                       *(c.data_ptr() for c in cores)], dtype=np.int64)


def tt_contract(x: torch.Tensor, cores: Sequence[torch.Tensor],
                spec: tt_lib.TTSpec) -> torch.Tensor:
    """``y = x @ W(cores)^T`` on the card.  x: (..., N) f32 → (..., M) f32;
    extra batch axes are flattened for the launch and restored."""
    _check_x("tt_contract", x, spec)
    _check_cores(cores, spec, x.device)
    batch_shape = x.shape[:-1]
    B = math.prod(batch_shape)
    y = torch.empty((*batch_shape, spec.out_dim), dtype=torch.float32,
                    device=x.device)
    if B == 0:
        return y
    if B >= 2**31:
        raise ValueError(f"batch of {B} rows exceeds the kernel's int32 range")
    tile = fiber_tile(spec, B)
    desc = _descriptor(cores, spec)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launchers()[0](x.data_ptr(), y.data_ptr(), desc.ctypes.data,
                              B, tile.rows, stream)
    if err != 0:
        raise RuntimeError(f"tt_contract launch failed: CUDA error {err}")
    tt_contract.launches += 1
    return y


tt_contract.launches = 0

MAX_STACK = 65_535                 # the grid's y extent
CODE_TYPES = {"int8": 0, "fp8_e4m3": 1}  # code_type in the source


def _check_stack(cores: Sequence[torch.Tensor], spec: tt_lib.TTSpec,
                 device: torch.device) -> int:
    """Check P stacked f32 core sets on ``device``; return P."""
    if not cores:
        raise ValueError("need at least one core stack")
    P = cores[0].shape[0]
    _check_cores(cores, spec, device, stack=(P,))
    if not 1 <= P <= MAX_STACK:
        raise ValueError(f"core stack of {P} entries; the kernel takes "
                         f"1..{MAX_STACK}")
    return P


def _launch_batched(entry, launcher: int, x: torch.Tensor,
                    cores: Sequence[torch.Tensor], spec: tt_lib.TTSpec,
                    shared_x: bool | None, *args) -> torch.Tensor:
    """Check, tile and launch the batched C entry ``launcher`` for the
    wrapper ``entry`` (whose launches it counts); ``args`` go between the
    rows per block and the stream."""
    name = entry.__name__
    _check_x(name, x, spec)
    P = _check_stack(cores, spec, x.device)
    xf, batch_shape, shared = _ref.split_batch_axes(x, P, spec, shared_x)
    B = xf.shape[-2]
    y = torch.empty((P, *batch_shape, spec.out_dim), dtype=torch.float32,
                    device=x.device)
    if B == 0:
        return y
    if P * B >= 2**31:
        raise ValueError(f"{P} x {B} rows exceed the kernel's int32 range")
    tile = fiber_tile(spec, P * B)
    desc = _descriptor(cores, spec)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launchers()[launcher](
            xf.data_ptr(), y.data_ptr(), desc.ctypes.data, B, P,
            0 if shared else B * spec.in_dim, tile.rows, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    entry.launches += 1
    return y


def tt_contract_batched(x: torch.Tensor, cores: Sequence[torch.Tensor],
                        spec: tt_lib.TTSpec,
                        shared_x: bool | None = None) -> torch.Tensor:
    """``y[p] = x(shared or [p]) @ W(cores[p])^T`` for P stacked core sets
    in one launch.  cores: each ``(P, r, m, n, r')``; x ``(..., N)`` shared
    or ``(P, ..., N)`` per entry, resolved as ``kernels.ref.
    split_batch_axes`` does (``shared_x=None``: 2-D is shared).  Returns
    ``(P, *batch_axes, M)``."""
    return _launch_batched(tt_contract_batched, 1, x, cores, spec, shared_x)


tt_contract_batched.launches = 0


def tt_contract_batched_quant(x: torch.Tensor, cores: Sequence[torch.Tensor],
                              spec: tt_lib.TTSpec,
                              quant: quant_lib.QuantConfig,
                              shared_x: bool | None = None) -> torch.Tensor:
    """``tt_contract_batched`` with block-scaled int8 / fp8-e4m3 cores.

    The kernel reads each of the P f32 core variants and quantizes it on
    chip, in the block, before the chain: runs of ``quant.block`` elements,
    each with its absmax scale, to the values ``quant.fake_quant_stacked``
    gives, bit for bit.  So entry p equals ``tt_contract_batched`` on the
    fake-quantized cores bit for bit, and the call is one launch.  x and
    the output as in ``tt_contract_batched``."""
    if not quant.weights:
        raise ValueError(f"weight quantization not enabled in {quant}")
    return _launch_batched(tt_contract_batched_quant, 2, x, cores, spec,
                           shared_x, quant.block, CODE_TYPES[quant.dtype])


tt_contract_batched_quant.launches = 0
