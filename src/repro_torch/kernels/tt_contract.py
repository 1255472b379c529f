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
its plain chain).  A block runs the forward steps once, keeping the
states the reverse sweep needs in shared memory (``grad_tile``: all of
them at the paper's spec, fewer for wider rows), then steps dA back while
it adds each core's gradient in registers, a fiber at a time; the blocks'
partials are summed in the same launch, in a fixed order, by the last
block to finish: no float atomics, so two calls on the same inputs give
the same bits.  ``TTContractFn`` is the autograd Function
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
           "grad_tile", "grad_grid", "grad_smem_bytes", "grad_bound",
           "FiberTile", "GradTile"]

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


RED_FLOATS = 16 * 64               # kRedFloats in the source
SUM_CHUNK = 16                     # kSumChunk: partials added 16 at a time
SUM_GROUP = 32                     # kSumGroup: the fewest blocks a group
# the backward's blocks an SM (__launch_bounds__(128, 3)), as many as its
# shared memory lets, from 3 down
GRAD_BLOCKS_PER_SM = 3


@dataclasses.dataclass(frozen=True)
class GradTile:
    """A launch of ``tt_contract_grad``: ``rows`` a tile (each block walks
    its tiles, ``grad_grid``), ``saved`` forward states kept on chip
    (``buffers`` = saved + 1 row buffers of ``stride`` floats, dA in one
    of them), ``blocks_per_sm`` blocks an SM that its shared memory
    allows, the forward's template widths and the dynamic shared memory,
    as ``parse_grad`` in the source lays them out."""
    rows: int
    stride: int
    saved: int
    buffers: int
    blocks_per_sm: int
    caps: tuple
    smem_bytes: int


def min_saved(spec: tt_lib.TTSpec) -> int:
    """The fewest forward states the backward can keep: 1 when every
    forward step but the last is in place (``r·n_k == m_k·r'``), else 2 (x
    is stepped forward between two buffers)."""
    in_place = all(r * n == m * rn for r, m, n, rn in spec.core_shapes[:-1])
    return 1 if in_place else 2


def grad_smem_bytes(spec: tt_lib.TTSpec, rows: int, saved: int) -> int:
    """The backward's dynamic shared memory at ``rows`` a block and
    ``saved`` states, as ``parse_grad`` sizes it: the cores as loaded,
    their repacked and transposed forms, the combine's staging and saved +
    1 row buffers."""
    fwd = fiber_tile(spec)
    return 4 * (_core_floats(spec) + 2 * sum(c * c for c in fwd.caps)
                + RED_FLOATS + rows * fwd.stride * (saved + 1))


@functools.lru_cache(maxsize=256)
def grad_tile(spec: tt_lib.TTSpec, rows_total: int | None = None
              ) -> GradTile:
    """Layout of ``tt_contract_grad`` for ``spec`` at ``rows_total`` rows
    (cached per pair: every call asks for it).

    Blocks an SM: ``GRAD_BLOCKS_PER_SM`` if a row of the fewest states the
    kernel takes fits, else 2, else one.  States: L or L - 1 (L: x read
    once and every forward step run once; L - 1: the same steps, x read
    again for the last reverse step), whichever fits more rows a tile, L on
    a tie; where neither fits (rows too wide), the most that fit, the
    others recomputed from x.  Rows a tile: at most what fits (and 32),
    then the count that fills the block slots' rounds of tiles best,
    rounds × (rows + 1) the least (the 1 stands for a tile's fixed cost:
    the combine, the barriers), the larger count on a tie.  Raises for
    fibers wider than ``MAX_FIBER`` and for a row that does not fit one
    block."""
    fwd = fiber_tile(spec)
    fixed = grad_smem_bytes(spec, 0, 0)
    lo = min_saved(spec)
    for per_sm in range(GRAD_BLOCKS_PER_SM, 0, -1):
        budget = (228 * 1024 // per_sm - 1024 if per_sm > 1
                  else SMEM_MAX_BYTES)
        fit = [s for s in range(lo, spec.L + 1)
               if grad_smem_bytes(spec, 1, s) <= budget]
        if fit:
            break
    else:
        raise ValueError(f"the backward of {spec} needs "
                         f"{grad_smem_bytes(spec, 1, lo)} B of shared "
                         f"memory per row; the card has {SMEM_MAX_BYTES} B "
                         f"per block")
    slots = per_sm * H100_SMS

    def plans(saved):
        """(cost, -saved, -rows) for each rows a tile that fits ``saved``
        states: the least is taken."""
        most = min(MAX_FIBER_ROWS,
                   (budget - fixed) // (4 * fwd.stride * (saved + 1)))
        if rows_total is None:
            return [(0, -saved, -most)]
        return [(-(-(-(-rows_total // r)) // slots) * (r + 1), -saved, -r)
                for r in range(1, most + 1)]

    choices = [s for s in fit if s >= spec.L - 1] or fit[-1:]
    _, neg_saved, neg_rows = min(p for s in choices for p in plans(s))
    saved, rows = -neg_saved, -neg_rows
    return GradTile(rows, fwd.stride, saved, saved + 1, per_sm, fwd.caps,
                    grad_smem_bytes(spec, rows, saved))


def grad_grid(tile: GradTile, rows_total: int) -> tuple:
    """``(tiles, blocks)`` of a ``tt_contract_grad`` launch: the row tiles
    of ``tile.rows`` rows, and the blocks that walk them (one wave of the
    card's block slots at most; block i takes tiles i, i + blocks, ...)."""
    tiles = -(-rows_total // tile.rows)
    return tiles, min(tiles, tile.blocks_per_sm * H100_SMS)


def grad_groups(blocks: int) -> tuple:
    """``(group, groups)`` of the backward's two-level sum: blocks a group
    ``ceil(sqrt(blocks))`` but at least ``SUM_GROUP`` (so up to that many
    blocks sum in one level), and the groups."""
    group = math.isqrt(blocks - 1) + 1 if blocks > 1 else 1
    group = max(group, min(blocks, SUM_GROUP))
    return group, -(-blocks // group)


def _sum_depth(n: int, floats: int) -> int:
    """Most additions a value passes through when ``n`` partials of
    ``floats`` each are summed as ``sum_partials`` does: ``floats / V``
    columns (V = 4 where ``floats % 4 == 0``, else 1) over the 128
    threads, the blocks split into ``parts = min(128 / columns, n)``
    ranges (1 for 128 columns or more); a range added ``SUM_CHUNK`` at a
    time pairwise, the chunks in order (the zeros that pad the last chunk
    round nothing), then the parts in order."""
    cols = floats // 4 if floats % 4 == 0 else floats
    parts = 1 if cols >= FIBER_THREADS else min(FIBER_THREADS // cols, n)
    length = -(-n // parts)
    return ((min(length, SUM_CHUNK) - 1).bit_length()
            + -(-length // SUM_CHUNK) - 1 + parts - 1)


def _grad_depth(spec: tt_lib.TTSpec, k: int, rows: int, tiles: int,
                blocks: int) -> int:
    """The most additions a product of dG_k passes through in
    ``tt_contract_grad``, in its order: a thread's fibers in turn (fibers
    up to 8 wide: ``fpr / 128`` of a row times its rows; wider: a row's
    fibers over the 32·wpt lanes of an 8 x 8 tile, rows in turn), the 5
    rounds of the warp's butterfly, the tile's warps in turn (4, or wpt),
    a block's ``ceil(tiles / blocks)`` tiles in turn, then the blocks of a
    group and the groups, each ``_sum_depth`` of the cores'
    ``num_params`` floats."""
    r, m, n, rn = spec.core_shapes[k]
    f_in, f_out = r * n, m * rn
    mp, ns = _ref.fiber_shapes(spec, k)
    fpr = mp * ns
    warps = FIBER_THREADS // 32
    if max(f_in, f_out) <= 8:
        fibers = -(-fpr // FIBER_THREADS) * -(-rows // max(
            1, FIBER_THREADS // fpr))
    else:
        tiles_dg = -(-f_in // 8) * -(-f_out // 8)
        warps //= min(warps, 1 << (tiles_dg - 1).bit_length())
        fibers = rows * -(-fpr // (32 * warps))
    group, groups = grad_groups(blocks)
    return (fibers + 5 + warps - 1 + -(-tiles // blocks) - 1
            + _sum_depth(group, spec.num_params)
            + _sum_depth(groups, spec.num_params))


def grad_bound(x: torch.Tensor, cores: Sequence[torch.Tensor],
               spec: tt_lib.TTSpec, dy: torch.Tensor) -> list:
    """Per element of each dG_k, how far ``tt_contract_grad`` may sit from
    the exact gradient (``ref.tt_contract_grad_ref`` in float64):
    ``1.01·(h_k + c)·2^-24·S_k``.  ``S_k`` is the same reduction over |x|,
    |G| and |dy| in float64 (the magnitudes of every product it adds, and
    of the chain products behind them); ``h_k`` the kernel's summation
    depth at this launch's tiling (``_grad_depth``: it grows with the
    fibers a thread adds and with the blocks); ``c = 2·Σ_k max(r·n_k,
    m_k·r')`` covers the rounding of the states A_k and dA_{k+1} it
    multiplies.  The 1.01 covers the second-order terms."""
    B = math.prod(x.shape[:-1])
    tile = grad_tile(spec, B)
    tiles, blocks = grad_grid(tile, B)
    _, sums = _ref.tt_contract_grad_ref(
        x.double().abs(), [c.double().abs() for c in cores], spec,
        dy.double().abs(), need_dx=False)
    c = 2 * sum(max(r * n, m * rn) for r, m, n, rn in spec.core_shapes)
    return [1.01 * (_grad_depth(spec, k, tile.rows, tiles, blocks) + c)
            * 2.0 ** -24 * s for k, s in enumerate(sums)]


_TICKETS: dict = {}


def _tickets(device: torch.device, count: int) -> torch.Tensor:
    """The backward's int32 tickets on ``device``, at least ``count`` of
    them, zero: each launch leaves them zero again, so one zeroed buffer a
    device serves every call (a larger one replaces it when a call needs
    more)."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 64), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


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
    grad.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
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


@functools.lru_cache(maxsize=256)
def _core_sizes(spec: tt_lib.TTSpec) -> tuple:
    return tuple(math.prod(s) for s in spec.core_shapes)


@functools.lru_cache(maxsize=256)
def _descriptor_head(spec: tt_lib.TTSpec) -> tuple:
    return (spec.L, chain_widest(spec), *spec.out_modes, *spec.in_modes,
            *spec.ranks)


def _descriptor(cores: Sequence[torch.Tensor], spec: tt_lib.TTSpec):
    return np.asarray([*_descriptor_head(spec),
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
    backward step is skipped.  One launch a call: the blocks' partials are
    summed in the kernel, in a fixed order, by the last block to finish.
    Calls on one device share its tickets (``_tickets``), so they must not
    overlap on two streams; the port runs BP on one stream."""
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
        grad.split(_core_sizes(spec)), spec.core_shapes)]
    dx = torch.empty_like(x) if need_dx else None
    if B == 0:
        grad.zero_()
        return dx, grads
    if B >= 2**31:
        raise ValueError(f"batch of {B} rows exceeds the kernel's int32 range")
    tile = grad_tile(spec, B)
    _, blocks = grad_grid(tile, B)
    groups = grad_groups(blocks)[1]
    partials = torch.empty((blocks + groups) * spec.num_params,
                           dtype=torch.float32, device=x.device)
    desc = _descriptor(cores, spec)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launchers()[3](x.data_ptr(), dy.data_ptr(),
                              dx.data_ptr() if need_dx else None,
                              partials.data_ptr(), grad.data_ptr(),
                              _tickets(x.device, groups + 1).data_ptr(),
                              desc.ctypes.data, B, tile.rows, tile.saved,
                              blocks, stream)
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
