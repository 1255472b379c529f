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

``tt_contract_grad`` is the backward of ``tt_contract`` for the off-chip
BP baselines (the JAX package has no backward kernel: it differentiates
its plain chain).  It recomputes each block's forward states from x on
chip, steps dA back through the same fiber body on the transposed cores,
and reduces each core's gradient per block, then sums the blocks' partials
in a second, fixed-order pass: no float atomics, so two calls on the same
inputs give the same bits.  ``TTContractFn`` is the autograd Function
around the forward launch and this backward; ``tt_contract`` runs its
launch inside it whenever an input requires grad, so a gradient can never
silently stop at the kernel.

The wrappers check what the kernels take and raise on anything else; they
never fall back to the plain versions.  They allocate the output (and the
backward's scratch), launch on the current stream without synchronizing,
and count their launches in ``tt_contract.launches``,
``tt_contract_batched.launches``, ``tt_contract_batched_quant.launches``
and ``tt_contract_grad.launches``.
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
           "tt_contract_grad", "TTContractFn", "chain_widest", "fiber_tile",
           "grad_tile", "grad_bound", "FiberTile"]

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


RED_FLOATS = 16 * 64               # kRedSlots 8x8 tiles in the source


def grad_tile(spec: tt_lib.TTSpec, rows_total: int | None = None) -> FiberTile:
    """Tiling of ``tt_contract_grad``'s block pass, as ``parse_grad`` in the
    source lays it out: the forward's fibers and steps, shared memory for
    the cores, their repacked and transposed forms, the reduction's slots
    and the forward and backward row buffers (one each when every step is
    in place, else two), and rows a block chosen by ``fiber_tile``'s rule.
    Raises where ``fiber_tile`` does."""
    fwd = fiber_tile(spec)
    stride, buffers = fwd.stride, 2 * fwd.buffers
    fixed = 4 * (_core_floats(spec) + 2 * sum(c * c for c in fwd.caps)
                 + RED_FLOATS)
    per_row = 4 * buffers * stride
    rows = min(MAX_FIBER_ROWS, (SMEM_BLOCK_BUDGET - fixed) // per_row)
    if rows >= 8:
        rows -= rows % 8
    elif rows < 1:
        if fixed + per_row > SMEM_MAX_BYTES:
            raise ValueError(f"the backward of {spec} needs {fixed + per_row}"
                             f" B of shared memory per row; the card has "
                             f"{SMEM_MAX_BYTES} B per block")
        rows = 1
    if rows_total is not None:
        fill = -(-rows_total // (BLOCKS_PER_SM * H100_SMS))
        rows = max(1, min(rows, fill))
    return FiberTile(rows, stride, buffers, fwd.caps, fixed + rows * per_row)


def _grad_depth(spec: tt_lib.TTSpec, k: int, rows: int, blocks: int) -> int:
    """The most additions a product of dG_k passes through in
    ``tt_contract_grad``: the fibers a thread takes in turn (a tile of
    ``8 x 8`` entries on G threads, ``reduce_core_grad``), its lane tree,
    the G / W lane groups in turn, then a lane's blocks in turn and the
    32-lane tree of the sum kernel."""
    r, m, n, rn = spec.core_shapes[k]
    tiles = -(-r * n // 8) * -(-m * rn // 8)
    G = FIBER_THREADS // (1 << (tiles - 1).bit_length())
    W = min(G, 32)
    mp, ns = _ref.fiber_shapes(spec, k)
    return (-(-rows * mp * ns // G) + W.bit_length() - 1 + G // W
            + -(-blocks // 32) + 5)


def grad_bound(x: torch.Tensor, cores: Sequence[torch.Tensor],
               spec: tt_lib.TTSpec, dy: torch.Tensor) -> list:
    """Per element of each dG_k, how far ``tt_contract_grad`` may sit from
    the exact gradient (``ref.tt_contract_grad_ref`` in float64):
    ``1.01·(h_k + c)·2^-24·S_k``.  ``S_k`` is the same reduction over |x|,
    |G| and |dy| in float64 (the magnitudes of every product it adds, and
    of the chain products behind them); ``h_k`` the kernel's summation
    depth at this launch's tiling (``_grad_depth``: it grows with the
    reduction length B·M_<k·N_>k over the rows a block and the blocks);
    ``c = 2·Σ_k max(r·n_k, m_k·r')`` covers the rounding of the states A_k
    and dA_{k+1} it multiplies.  The 1.01 covers the second-order terms."""
    B = math.prod(x.shape[:-1])
    rows = grad_tile(spec, B).rows
    blocks = -(-B // rows)
    _, sums = _ref.tt_contract_grad_ref(
        x.double().abs(), [c.double().abs() for c in cores], spec,
        dy.double().abs(), need_dx=False)
    c = 2 * sum(max(r * n, m * rn) for r, m, n, rn in spec.core_shapes)
    return [1.01 * (_grad_depth(spec, k, rows, blocks) + c) * 2.0 ** -24 * s
            for k, s in enumerate(sums)]


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
    grad = lib.tt_contract_grad_launch
    grad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p]
    for fn in (single, batched, quant, grad):
        fn.restype = ctypes.c_int
    return single, batched, quant, grad


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
    extra batch axes are flattened for the launch and restored.  With grad
    enabled and an input that requires grad, the launch runs inside
    ``TTContractFn``, so the output carries the backward kernel."""
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(c.requires_grad for c in cores)):
        return TTContractFn.apply(x, spec, *cores)
    return _launch(x, cores, spec)


def _launch(x: torch.Tensor, cores: Sequence[torch.Tensor],
            spec: tt_lib.TTSpec) -> torch.Tensor:
    """The forward launch itself (outside autograd)."""
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


def tt_contract_grad(x: torch.Tensor, cores: Sequence[torch.Tensor],
                     spec: tt_lib.TTSpec, dy: torch.Tensor,
                     need_dx: bool = True) -> tuple:
    """The gradients of ``y = tt_contract(x, cores, spec)`` against ``dy``
    (shaped like y) on the card: ``(dx or None, [dG_k])``, each dG_k shaped
    like its core (views into one buffer).  Without ``need_dx`` the last
    backward step is skipped.  One call launches the block pass and the
    fixed-order sum of its partials."""
    _check_x("tt_contract_grad", x, spec)
    _check_cores(cores, spec, x.device)
    batch_shape = x.shape[:-1]
    if (dy.device != x.device or dy.dtype != torch.float32
            or tuple(dy.shape) != (*batch_shape, spec.out_dim)
            or not dy.is_contiguous()):
        raise ValueError(f"dy: need a contiguous float32 "
                         f"{(*batch_shape, spec.out_dim)} tensor on "
                         f"{x.device}, got {dy.dtype} {tuple(dy.shape)} on "
                         f"{dy.device}")
    B = math.prod(batch_shape)
    grad = torch.empty(spec.num_params, dtype=torch.float32, device=x.device)
    grads = [g.view(shape) for g, shape in zip(
        grad.split([math.prod(s) for s in spec.core_shapes]),
        spec.core_shapes)]
    dx = torch.empty_like(x) if need_dx else None
    if B == 0:
        grad.zero_()
        return dx, grads
    if B >= 2**31:
        raise ValueError(f"batch of {B} rows exceeds the kernel's int32 range")
    tile = grad_tile(spec, B)
    blocks = -(-B // tile.rows)
    partials = torch.empty(blocks * spec.num_params, dtype=torch.float32,
                           device=x.device)
    desc = _descriptor(cores, spec)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launchers()[3](x.data_ptr(), dy.data_ptr(),
                              dx.data_ptr() if need_dx else None,
                              partials.data_ptr(), grad.data_ptr(),
                              desc.ctypes.data, B, tile.rows, int(need_dx),
                              stream)
    if err != 0:
        raise RuntimeError(f"tt_contract_grad launch failed: CUDA error {err}")
    tt_contract_grad.launches += 1
    return dx, grads


tt_contract_grad.launches = 0


class TTContractFn(torch.autograd.Function):
    """``tt_contract`` under autograd: the forward is the launch serving and
    ZO run, the backward ``tt_contract_grad`` (``dx`` only where x needs a
    gradient).  x and the cores are made contiguous here, as the kernels
    take them."""

    @staticmethod
    def forward(ctx, x, spec, *cores):
        x = x.contiguous()
        cores = [c.contiguous() for c in cores]
        ctx.spec = spec
        ctx.save_for_backward(x, *cores)
        return _launch(x, cores, spec)

    @staticmethod
    def backward(ctx, dy):
        x, *cores = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        if not (need_dx or any(ctx.needs_input_grad[2:])):
            return (None,) * (2 + len(cores))
        dx, grads = tt_contract_grad(x, cores, ctx.spec, dy.contiguous(),
                                     need_dx)
        return (dx, None, *grads)


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
