"""Wrappers of the hand-written CUDA mesh kernels (``csrc/mesh_apply.cu``).

Replace the Pallas kernel ``repro/kernels/mesh_apply.py::
mesh_apply_stacked_pallas`` (its ``pallas_call`` at line 136), which ran
S stacked MZI meshes of one layout on x shared across the stack or per
entry, with trig tables built outside the kernel, and the JAX package's
jnp gather scan that took the meshes too wide for it
(``repro/kernels/ops.py:139-140``).  Here the kernels build their own trig
from the phases and the layout's plan (``core.photonic.mesh_plan_tensors``;
route A's ``rows_plan``).  Two entries:

  * ``mesh_apply_stacked`` — the standalone mesh, kernel-backed
    ``core.photonic.mesh_apply_stacked`` (``PhotonicMatrix.apply`` and
    ``apply_stacked``).  ``mesh_design`` picks ``resident`` from the layout
    alone where its trig and perm tables fit shared memory
    (``launch_resident``, up to ~138 ports of a rectangular mesh); every
    wider layout takes one of three routes, which ``wide_route`` picks
    from (layout, stack size, rows per entry):
      - ``warp_rows`` (route A, ``launch_warp_rows``): layouts whose
        levels pair adjacent wires of one parity (``adjacent_pairs``;
        every layout the repo builds); a warp holds whole rows in
        registers, a trig prologue writes the per-MZI records once a call;
      - ``dense`` (route B, ``launch_dense``): the same layouts at rows
        per entry of at least ``DENSE_MIN_ROWS_PER_PORT`` times the ports:
        route A densifies each entry's mesh on an identity feed and a
        3xTF32 tensor-core kernel multiplies;
      - ``owner_walk`` (``launch_owner_walk``): any other layout one row of
        which fits a block, one MZI per thread and item.
    The resident design, route A and the owner walk round every operation
    as the plain version does, so they agree with it bit for bit; route B
    agrees within the f32 bound ``1e-5·max|plain| + 1e-6``.
  * ``mesh_densify_stacked`` — ``PhotonicMatrix.to_dense_stacked`` of G
    matrices in one launch, DAC snap and noise model included, each
    written as its TT core: the ZO step's whole densification
    (``TensorPinn.prepare_params_stacked``).  Its G descriptors go to the
    kernel by value (``MeshGroup``, a ctypes mirror of the C struct), so
    the launch copies nothing from the host.  Their static half is packed
    once a model (``GroupTemplate``, kept on the group's first matrix by
    ``group_template``); a call checks its tensors and writes their
    pointers.

Backwards, port-only (the TPU kernel has none; the JAX package
differentiates its jnp scan), for the off-chip BP baselines:

  * ``mesh_densify_grad`` — the grouped densification's, one launch for
    every matrix: dphases_u, dphases_v (of the commanded phases, through
    the noise model) and dsigma from the cores' gradients, through the
    design ``densify_grad_design`` picks for the group (counted in
    ``mesh_densify_grad.design_launches``): ``warp`` where every mesh is
    at most 32 ports wide (a mesh row in a warp's lanes, levels by
    shuffles, every level's input kept, no block barrier a level), else
    ``block`` (one element a thread, a barrier a level; the forward's
    states kept in shared memory where they fit, ``densify_grad_saves``,
    else recovered).  The same group template as the forward's.
    ``MeshDensifyFn`` puts it under autograd.
  * ``mesh_apply_stacked_grad`` — the standalone mesh's, through the
    design ``grad_design`` picks, which follows the forward's route
    (``MeshApplyFn``): ``resident`` where the resident backward's tables
    fit a block (``grad_fits``), by the design ``resident_grad_design``
    picks (counted in ``mesh_apply_stacked_grad.resident_launches``):
    ``warp`` for meshes of at most 32 ports and brick layouts of at most
    64 (a mesh row in a warp's lanes, the states recovered level by level
    by shuffles, no block barrier a level; one launch, or with many block
    columns a second that sums them, ``resident_grad_warp_config``), else
    ``block`` (an element a thread, a barrier a level); ``dense`` where
    the forward took route
    B, which keeps x and its dense scratch M (y = x·M): dx = dy·Mᵀ and
    dM = xᵀ·dy on the tensor cores in one launch (``mesh_product_grad``,
    3xTF32, dM's k split over the card, ``dense_grad_splits``), then
    dphases by the warp-rows backward on M's P identity rows; else
    ``warp_rows``, dx and dphases from the saved output, the states
    recovered level by level in route A's register layout walked in
    reverse (``grad_rows_config``, ``grad_slot_map``).  The owner walk's
    layouts (pairs of wires that are not adjacent, or more than 1024
    ports) have no backward (ROADMAP item 6c-3).

Each is held to its plain version (``kernels.ref.mesh_densify_grad_ref``,
``mesh_apply_grad_ref``, ``mesh_apply_dense_grad_ref``), and sums in a
fixed order, no float atomics: two calls give the same bits.

The TPU's one-hot permutation matmul (``mesh_perm_onehot``) has no
counterpart: the kernels read a wire's partner from shared memory or a
neighbouring lane.  The TPU's size limits assumed VMEM; here a block holds
its tables and buffers in at most Hopper's 232,448 bytes of shared memory
(``smem_bytes``, ``stream_smem_bytes``, ``densify_smem_bytes``,
``grad_rows_smem_bytes``), and what no design holds raises — there is no
plain fallback on the card.

Each wrapper checks what its kernel takes and raises on anything else,
allocates the output and its scratch, launches on the current stream
without synchronizing, and counts its launches (``<wrapper>.launches``;
per design and route ``mesh_apply_stacked.design_launches`` and
``mesh_apply_stacked_grad.design_launches``, and per resident design
``mesh_apply_stacked_grad.resident_launches``, one count a call).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.core import photonic as ph_lib
from repro_torch.kernels import _build
from repro_torch.kernels.tt_contract import SMEM_MAX_BYTES

__all__ = ["mesh_apply_stacked", "launch_resident", "launch_warp_rows",
           "launch_dense", "launch_owner_walk", "mesh_design", "wide_route",
           "DESIGNS", "WIDE_ROUTES", "adjacent_pairs", "lane_width",
           "level_modes", "rows_plan", "rows_config", "trig_records",
           "DENSE_MIN_ROWS_PER_PORT", "mesh_densify_stacked", "smem_bytes",
           "rows_per_block", "stream_smem_bytes", "stream_rows",
           "densify_smem_bytes", "MeshGroup", "pack_group", "MAX_GROUP",
           "GroupTemplate", "group_template", "TEMPLATES_KEPT",
           "GRAD_GROUP_DESIGNS", "densify_grad_design", "densify_grad_warps",
           "densify_grad_warp_smem_bytes",
           "mesh_densify_grad", "mesh_apply_stacked_grad", "grad_smem_bytes",
           "grad_fits", "grad_rows_per_block", "grad_columns",
           "RESIDENT_GRAD_DESIGNS", "resident_grad_design",
           "resident_grad_warp_config", "resident_grad_warp_smem_bytes",
           "densify_grad_smem_bytes", "densify_grad_saves", "MeshApplyFn",
           "MeshDensifyFn", "apply_autograd", "densify_autograd",
           "PARAM_KEYS", "route_a_takes", "grad_design",
           "GRAD_DESIGNS", "grad_slot_map", "grad_rows_config",
           "grad_rows_smem_bytes", "grad_scratch_bytes", "launch_dense_keep",
           "term_word", "mesh_product_grad", "dense_grad_splits"]

MAX_ROW_ELEMENTS = 1024            # rows per block × ports, at most
MAX_STACK = 65_535                 # the standalone grid's y extent
MAX_GROUP = 20                     # kMaxGroup: matrices per grouped launch
DESIGNS = ("resident", "warp_rows", "dense", "owner_walk")
WIDE_ROUTES = DESIGNS[1:]
GRAD_DESIGNS = ("resident", "warp_rows", "dense")
ROT_BYTES = 24                     # sizeof(Rot): an owner walk's entry
LANE_WIDTHS = (8, 16, 32)          # route A's wires a lane (W), compiled
ROWS_PER_WARP = (4, 2, 1)          # route A's rows a warp (R), compiled
ROWS_BLOCK_WARPS = 4               # warps a block (the C entry takes 8)
ROWS_FILL_WARPS = 8                # warps a multiprocessor route A aims at
# route B from this many rows per entry per port (ports % 4 == 0): at 1024
# ports the routes cross at ~1.34 x ports rows per entry, at S = 11 and at
# S = 1 alike (tools/mesh_wide.py; PERF.md §6 row 7)
DENSE_MIN_ROWS_PER_PORT = 1.5


def smem_bytes(ports: int, levels: int, rows: int) -> int:
    """Shared memory of one standalone block: cos, sin and perm tables
    ``(levels, ports)``, the diag row and two row buffers."""
    return 4 * (3 * levels * ports + ports + 2 * rows * ports)


def rows_per_block(layout: ph_lib.MeshLayout) -> int:
    """Rows of x one block holds: about 1024 elements, within the shared
    memory left after the tables.  Raises for a layout whose tables and
    one row do not fit a block."""
    P, L = layout.ports, layout.levels
    if smem_bytes(P, L, 1) > SMEM_MAX_BYTES:
        raise ValueError(
            f"a {P}-port, {L}-level mesh needs {smem_bytes(P, L, 1)} B of "
            f"shared memory per block; the card has {SMEM_MAX_BYTES} B")
    fit = (SMEM_MAX_BYTES - smem_bytes(P, L, 0)) // (8 * P)
    return max(1, min(MAX_ROW_ELEMENTS // P, fit))


def mesh_design(layout: ph_lib.MeshLayout) -> str:
    """``"resident"`` where the layout's tables and one row fit a block
    (``rows_per_block``), else ``"wide"`` (``wide_route`` picks the
    route)."""
    fits = smem_bytes(layout.ports, layout.levels, 1) <= SMEM_MAX_BYTES
    return "resident" if fits else "wide"


def _level_parities(layout: ph_lib.MeshLayout) -> np.ndarray | None:
    """Each level's pair parity (the lower wire of every pair mod 2; 0 for
    a level without pairs), or None if some pair joins wires that are not
    adjacent, or one level holds pairs of both parities."""
    memo = layout.__dict__.get("_level_parities", False)
    if memo is not False:
        return memo
    lo = np.minimum(layout.idx_a, layout.idx_b)
    hi = np.maximum(layout.idx_a, layout.idx_b)
    par = np.where(layout.mask, lo % 2, -1)
    out = None
    if ((hi - lo)[layout.mask] == 1).all():
        first = par.max(axis=1)                        # -1: no pairs
        if (np.where(layout.mask, par == first[:, None], True)).all():
            out = np.maximum(first, 0).astype(np.int32)
    object.__setattr__(layout, "_level_parities", out)
    return out


def adjacent_pairs(layout: ph_lib.MeshLayout) -> bool:
    """Route A's predicate: every pair joins adjacent wires (a, a+1), and
    the pairs of a level share the parity of a (a "brick" level).  The
    rectangular and the Reck layouts the repo builds hold; a layout
    ``schedule_ops`` makes of any other pairs may not."""
    return _level_parities(layout) is not None


def route_a_takes(layout: ph_lib.MeshLayout) -> bool:
    """Whether routes A and B (and the warp-rows backward) take the layout:
    at most 1024 ports, and ``adjacent_pairs``."""
    return lane_width(layout.ports) is not None and adjacent_pairs(layout)


def lane_width(ports: int) -> int | None:
    """Route A's wires a lane: the narrowest compiled W with 32·W ≥ ports
    (None past 1024 ports)."""
    return next((w for w in LANE_WIDTHS if 32 * w >= ports), None)


def level_modes(layout: ph_lib.MeshLayout) -> np.ndarray:
    """Route A's per-level mode, ``(levels,)`` int32: bit 0 the level's
    parity p, bit 1 "partial" — a brick pair (a, a+1), a ≡ p, inside the
    ports that the level leaves out, or wire P-1 unpaired (P-1 ≡ p) where
    it does not end a lane (P not a multiple of W).  A full level's only
    unpaired wires are then 0 and P-1 at a lane's edge, which the kernel
    takes without a select.  Raises for a layout ``adjacent_pairs``
    refuses."""
    par = _level_parities(layout)
    if par is None:
        raise ValueError("route A takes layouts whose levels pair adjacent "
                         "wires of one parity")
    P, W = layout.ports, lane_width(layout.ports)
    perm = ph_lib.mesh_gather_plan(layout)[0]
    modes = par.copy()
    for c, p in enumerate(par):
        lo = np.arange(p, P - 1, 2)
        partial = (perm[c, lo] != lo + 1).any() or (
            (P - 1) % 2 == p and (W is None or P % W != 0))
        modes[c] |= 2 * int(partial)
    return modes


def record_floats(W: int) -> int:
    """Floats of one level's trig record at lane width W: (W/2 + 1) × 32
    brick entries (cos, s_lo), 32 words of absent bits, the level's mode
    and 3 words of padding."""
    return (W // 2 + 1) * 64 + 36


SLOT_BITS, SIGN_SHIFT, WIRE_BIT = 24, 24, 1 << 26


def rows_plan(layout: ph_lib.MeshLayout) -> np.ndarray:
    """Route A's record plan, host-built once per layout: per stored level
    ``(W/2 + 1)·32 + 33`` int32 — a code per brick entry (lane t's entry i
    at a level of parity p joins wires lo = t·W + 2i − p and lo + 1): the
    slot of its phase (bits 0–23), its wire's sign (bits 24–25: 0, +1 as
    1, −1 as 2) and ``WIRE_BIT`` where the entry holds a wire (a pair's
    lower wire, else its one unpaired wire in range); then the absent word
    of each lane (bit i: entry i is no pair) and the level's mode
    (``level_modes``).  The trig prologue reads it beside the phases.
    Memoized on the layout."""
    memo = layout.__dict__.get("_rows_plan")
    if memo is not None:
        return memo
    P, L = layout.ports, layout.levels
    W = lane_width(P)
    E = W // 2 + 1
    perm, slot, sign = ph_lib.mesh_gather_plan(layout)
    modes = level_modes(layout)
    i, lane = np.meshgrid(np.arange(E), np.arange(32), indexing="ij")
    lo = lane * W + 2 * i - (modes & 1)[:, None, None]       # (L, E, 32)
    cl = np.arange(L)[:, None, None]
    pair = (lo >= 0) & (lo + 1 < P)
    pair &= perm[cl, np.clip(lo, 0, P - 1)] == lo + 1
    w = np.where((lo >= 0) & (lo < P), lo, np.where(lo + 1 < P, lo + 1, -1))
    wc = np.clip(w, 0, P - 1)
    sg = sign[cl, wc]
    code = (slot[cl, wc].astype(np.int64)
            | np.where(sg > 0, 1, np.where(sg < 0, 2, 0)) << SIGN_SHIFT
            | np.where(w >= 0, WIRE_BIT, 0))
    absent = ((~pair).astype(np.int64) << np.arange(E)[None, :, None]
              ).sum(axis=1)                                    # (L, 32)
    plan = np.concatenate([code.reshape(L, E * 32), absent, modes[:, None]],
                          axis=1).astype(np.uint32).view(np.int32)
    object.__setattr__(layout, "_rows_plan", plan)
    return plan


def _plan_tensor(layout: ph_lib.MeshLayout,
                 device: torch.device) -> torch.Tensor:
    memo = layout.__dict__.setdefault("_rows_plan_tensors", {})
    if device not in memo:
        memo[device] = torch.as_tensor(rows_plan(layout), device=device)
    return memo[device]


def trig_records(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                 transpose: bool = False) -> torch.Tensor:
    """The plain version of route A's trig prologue
    (``csrc/mesh_apply.cu::mesh_trig_kernel``): phases ``(S, levels,
    slots)`` → ``(S, levels, record_floats(W))`` float32 in stored level
    order.  From ``rows_plan``: an entry with a wire gets ``(cos φ if sign
    else 1, sign·sin φ)`` (the sine negated when transposed) — a pair's
    lower wire's, or an unpaired wire's ``(1, ±0)`` — an entry past the
    wires ``(1, 0)``; then the plan's absent words and mode as their int32
    bits, and 3 zero words."""
    P, L = layout.ports, layout.levels
    W = lane_width(P)
    E = W // 2 + 1
    plan = torch.as_tensor(rows_plan(layout).astype(np.int64),
                           device=phases.device)
    code = plan[:, :E * 32]
    has = (code & WIRE_BIT) != 0
    sc = (code >> SIGN_SHIFT) & 3
    sg = torch.where(sc == 1, 1.0, torch.where(sc == 2, -1.0, 0.0))
    S = phases.shape[0]
    v = torch.gather(phases, 2, (code & ((1 << SLOT_BITS) - 1))[None]
                     .expand(S, -1, -1))                     # (S, L, E*32)
    c = torch.where(has & (sg != 0.0), torch.cos(v), torch.ones_like(v))
    s = torch.where(has, sg * torch.sin(v), torch.zeros_like(v))
    if transpose:
        s = torch.where(has, -s, s)
    ent = torch.stack([c, s], dim=-1).reshape(S, L, E * 64)
    tail = torch.cat([plan[:, E * 32:], torch.zeros((L, 3), dtype=torch.int64,
                                                    device=phases.device)],
                     dim=1).to(torch.int32).view(torch.float32)
    return torch.cat([ent, tail.expand(S, L, 36)], dim=-1).contiguous()


def rows_config(layout: ph_lib.MeshLayout, S: int, rows: int,
                sms: int) -> tuple:
    """Route A's launch: (W, rows per warp R, warps per block).  R is the
    largest of ``ROWS_PER_WARP`` that still gives ``ROWS_FILL_WARPS``
    warps per multiprocessor (a warp walks the levels in sequence, so a
    small batch runs fastest one row a warp); blocks of 4 warps, which
    measured faster than 2, 8 or 16 at onn's launches (tools/mesh_wide.py):
    more blocks share the multiprocessors evenly, and the trig each block
    streams costs one bulk copy a chunk."""
    W = lane_width(layout.ports)
    R = next((r for r in ROWS_PER_WARP
              if S * -(-rows // r) >= ROWS_FILL_WARPS * sms), 1)
    return W, R, min(ROWS_BLOCK_WARPS, -(-rows // R))


def wide_route(layout: ph_lib.MeshLayout, S: int, rows: int) -> str:
    """The route of a wide layout (``mesh_design`` ``"wide"``) for S
    stacked meshes on ``rows`` rows per entry: ``"owner_walk"`` unless
    route A takes the layout (``adjacent_pairs``, at most 1024 ports);
    then ``"dense"`` from ``DENSE_MIN_ROWS_PER_PORT`` × ports rows per
    entry (ports % 4 == 0, the product's 16-byte copies), else
    ``"warp_rows"``.  The crossover measured the same at S = 1 and 11, so
    S does not move it."""
    P = layout.ports
    if not route_a_takes(layout):
        return "owner_walk"
    if P % 4 == 0 and rows >= DENSE_MIN_ROWS_PER_PORT * P:
        return "dense"
    return "warp_rows"


def stream_smem_bytes(ports: int, items: int, rows: int) -> int:
    """Shared memory of one owner-walk block: two owner lists of ``items``
    entries (the level being applied and the next) and ``rows`` rows plus
    the diag row."""
    return 2 * ROT_BYTES * items + 4 * (rows + 1) * ports


def stream_rows(layout: ph_lib.MeshLayout, stack: int, batch: int,
                sms: int) -> int:
    """Rows of x one owner-walk block holds: as many as shared memory takes,
    or fewer so that the grid's waves over ``sms`` multiprocessors come
    out whole (a small batch then spreads over every SM instead of a few
    full blocks).  Raises for a layout one row of which does not fit."""
    P = layout.ports
    items = ph_lib.mesh_owner_plan(layout).shape[1]
    fit = (SMEM_MAX_BYTES - stream_smem_bytes(P, items, 0)) // (4 * P)
    if fit < 1:
        raise ValueError(
            f"a {P}-port mesh needs {stream_smem_bytes(P, items, 1)} B of "
            f"shared memory per owner-walk block; the card has "
            f"{SMEM_MAX_BYTES} B")
    tiles = -(-batch // fit)
    waves = -(-stack * tiles // sms)
    tiles = min(batch, waves * sms // stack)
    return -(-batch // tiles)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grad_smem_bytes(ports: int, levels: int, rows: int) -> int:
    """Shared memory of one resident backward block: the forward's tables
    and diag row, and four row buffers (the recovered states, the
    gradients, a scratch of each)."""
    return 4 * (3 * levels * ports + ports + 4 * rows * ports)


def grad_fits(layout: ph_lib.MeshLayout) -> bool:
    """Whether the resident backward holds the layout: its tables and one
    row of each buffer fit a block (a rectangular mesh of up to ~138
    ports, as the forward's resident design).  Wider layouts take the
    dense or the warp-rows backward where route A takes them
    (``grad_design``)."""
    return grad_smem_bytes(layout.ports, layout.levels, 1) <= SMEM_MAX_BYTES


def grad_design(layout: ph_lib.MeshLayout, S: int = 1,
                rows: int | None = None) -> str | None:
    """The backward's design, which follows the forward's route:
    ``"resident"`` where ``grad_fits`` holds; for the layouts route A
    takes, ``"dense"`` where the forward of S meshes on ``rows`` rows per
    entry took route B (``wide_route``), whose x and dense scratch M it
    keeps, else ``"warp_rows"`` (route A's forwards, and a backward
    handed the forward's output y: ``rows`` None); None for the owner
    walk's layouts, which no backward holds (item 6c-3)."""
    if grad_fits(layout):
        return "resident"
    if not route_a_takes(layout):
        return None
    if rows is not None and mesh_design(layout) == "wide" and \
            wide_route(layout, S, rows) == "dense":
        return "dense"
    return "warp_rows"


def _grad_design_or_raise(layout: ph_lib.MeshLayout) -> str:
    """``grad_design``, raising for a layout no backward holds, naming
    item 6c-3."""
    design = grad_design(layout)
    if design is not None:
        return design
    raise ValueError(
        f"a {layout.ports}-port, {layout.levels}-level mesh has no backward "
        "kernel: the resident backward's tables do not fit a block, and the "
        "warp-rows backward takes layouts of at most 1024 ports whose "
        "levels pair adjacent wires of one parity; the owner walk's "
        "backward is ROADMAP queue A, item 6c-3")


def grad_rows_per_block(layout: ph_lib.MeshLayout) -> int:
    """Rows one resident backward block takes at a time: about 1024
    elements, within the shared memory left after the tables.  Raises
    where ``grad_fits`` does not hold (``grad_design`` names the design
    that takes such a layout, or item 6c-3)."""
    P, L = layout.ports, layout.levels
    if not grad_fits(layout):
        raise ValueError(
            f"the resident backward does not hold a {P}-port, {L}-level "
            f"mesh: it needs {grad_smem_bytes(P, L, 1)} B of shared memory "
            f"per block (the card has {SMEM_MAX_BYTES} B); route A's "
            "layouts take the warp-rows backward, and the owner walk's "
            "backward is ROADMAP queue A, item 6c-3")
    fit = (SMEM_MAX_BYTES - grad_smem_bytes(P, L, 0)) // (16 * P)
    return max(1, min(MAX_ROW_ELEMENTS // P, fit))


GRAD_BLOCKS_PER_SM = 4             # the resident backward's blocks an SM


def grad_columns(S: int, tiles: int, sms: int) -> int:
    """Block columns of the resident backward's grid ``(columns, S)``:
    about ``GRAD_BLOCKS_PER_SM`` blocks an SM, at most one a row tile.
    Each column walks every ``columns``-th tile and keeps its own phase
    gradients, which a second small kernel sums in column order: the
    scratch is ``columns × S × levels × slots`` floats, however many rows
    there are."""
    return max(1, min(tiles, -(-GRAD_BLOCKS_PER_SM * sms // S)))


RESIDENT_GRAD_DESIGNS = ("warp", "block")
RES_WARP_WARPS = 24                # the warp design's warps a block, about
RES_WARP_BLOCKS_PER_SM = 1         # ... its blocks an SM, at most
RES_WARP_MIN_GROUPS = 8            # ... a column's row groups, at least
# columns folded in the launch, at most: up to 16 the fold and the sum
# kernel take the same device time on an H100, and the fold saves a launch;
# past 16 the fold's one block is the slower (tools/mesh_apply_grad.py
# --variants)
RES_WARP_FOLD_COLUMNS = 16
RES_WARP_MAX_PORTS = 64            # the pairs lane layout's widest mesh


def _res_warp_pairs(layout: ph_lib.MeshLayout) -> bool | None:
    """The warp design's lane layout: False (lanes: a wire a lane) for
    meshes of 2 to 32 ports, True (pairs: two adjacent wires a lane) for
    brick layouts of 33 to 64 ports, None for any other layout."""
    P = layout.ports
    if 2 <= P <= 32:
        return False
    if P <= RES_WARP_MAX_PORTS and adjacent_pairs(layout):
        return True
    return None


def resident_grad_warp_smem_bytes(layout: ph_lib.MeshLayout,
                                  warps: int) -> int:
    """Shared memory of one warp-design block of ``warps`` warps: a
    16-byte record per level and lane (pairs: 32 lanes, and a word each;
    lanes: one per wire), and a region that holds the staging's plan and
    slot trig, then each warp's phase gradients (``csrc/mesh_apply.cu::
    res_warp_smem``)."""
    P, L, K = layout.ports, layout.levels, layout.slots
    return _res_warp_tables(layout) + 4 * max(2 * L * P + 2 * L * K,
                                              warps * L * K)


def _res_warp_tables(layout: ph_lib.MeshLayout) -> int:
    """The warp design's records (and pairs' words), in bytes."""
    L = layout.levels
    if _res_warp_pairs(layout):
        return 16 * L * 32 + 4 * L * 32
    return 16 * L * layout.ports


def resident_grad_design(layout: ph_lib.MeshLayout,
                         design: str | None = None) -> str:
    """The resident backward's design for a layout ``grad_fits`` holds:
    ``"warp"`` (``mesh_apply_grad_warp_kernel``: a mesh row in a warp's
    lanes, the states recovered by shuffles, no block barrier a level)
    for meshes of at most 32 ports and for brick layouts
    (``adjacent_pairs``) of 33 to 64 ports — every rectangular mesh the
    repo's configs build — else ``"block"`` (``mesh_apply_grad_kernel``,
    an element a thread, a barrier a level).  ``design`` forces one of
    ``RESIDENT_GRAD_DESIGNS``; ``"warp"`` raises for a layout it does not
    take."""
    takes = (_res_warp_pairs(layout) is not None and
             resident_grad_warp_smem_bytes(layout, 1) <= SMEM_MAX_BYTES)
    if design is None:
        return "warp" if takes else "block"
    if design not in RESIDENT_GRAD_DESIGNS or (design == "warp" and
                                               not takes):
        raise ValueError(
            f"the resident backward has no {design!r} design for a "
            f"{layout.ports}-port, {layout.levels}-level mesh (the warp "
            "design takes meshes of at most 32 ports, and brick layouts of "
            "at most 64)")
    return design


def resident_grad_warp_config(layout: ph_lib.MeshLayout, S: int, B: int,
                              sms: int) -> tuple:
    """The warp design's launch: ``(pairs, R, warps, columns, per_column,
    chunk, fold)``.  A warp walks row groups of R rows (lanes: ``32 //
    ports``; pairs: 1), ``chunk`` (1 or 2) at once; each of the
    ``columns`` blocks of an entry takes ``per_column`` consecutive
    groups, its warp q the groups q, q + warps, ... of them.  The columns
    spread an entry's groups over about ``RES_WARP_BLOCKS_PER_SM`` blocks
    an SM, at least ``RES_WARP_MIN_GROUPS`` groups a column; ``chunk`` is
    1 where every warp gets one group with at most ``RES_WARP_WARPS``
    warps (fewer where shared memory holds fewer warps' sums), else 2,
    and a warp walks its chunks in turn (on an H100 a chunk of 2 at half
    the warps is no faster where every warp has one group, and 1.4x
    slower on 100 rows of a 21-port mesh).  ``fold``: the launch sums the
    columns itself (``RES_WARP_FOLD_COLUMNS`` at most), else
    ``mesh_grad_sum_kernel`` does."""
    pairs = bool(_res_warp_pairs(layout))
    R = 1 if pairs else 32 // layout.ports
    groups = -(-B // R)
    columns = max(1, min(-(-groups // RES_WARP_MIN_GROUPS),
                         RES_WARP_BLOCKS_PER_SM * sms // S))
    per = -(-groups // columns)
    columns = -(-groups // per)
    fit = (SMEM_MAX_BYTES - _res_warp_tables(layout)) // (
        4 * layout.levels * layout.slots)
    most = max(1, min(RES_WARP_WARPS, fit))
    chunk = 1 if per <= most else 2
    warps = min(-(-per // chunk), most)
    return (pairs, R, warps, columns, per, chunk,
            columns <= RES_WARP_FOLD_COLUMNS)


GRAD_ROWS_MIN_WARPS = 4            # the warp-rows backward's block, at least
MAP_NEG = 1 << 16                  # kMapNeg: a slot's lower wire has sign -1


def term_word(W: int, i, t):
    """The word of a warp's row of phase terms (``(W/2 + 1)·32`` a level)
    that holds entry (i, t): ``i·32 + (t ^ ((64/W)·i mod 32))``, so that
    the 32 consecutive slots one warp of the sum reads fall in 32 banks
    (``csrc/mesh_apply.cu::term_word``)."""
    return i * 32 + (t ^ (64 // W) * i % 32)


def grad_slot_map(layout: ph_lib.MeshLayout) -> np.ndarray:
    """The warp-rows backward's slot map, host-built once per layout:
    ``(levels, map_stride)`` int32, ``map_stride`` the slots rounded up to
    4 (a level's row is a whole number of 16-byte words, as the bulk copy
    wants).  For stored level cl and slot k, the word of a warp's terms
    where the kernel keeps the term of entry (i, t) of ``rows_plan``
    whose lane t owns the slot's pair — at parity 0 its pairs (2i, 2i+1),
    i < W/2; at parity 1 its pairs (2i−1, 2i), 1 ≤ i < W/2, and i = W/2,
    the pair across its right edge: ``term_word(W, i, t)`` — with
    ``MAP_NEG`` set where the pair's lower wire has sign −1; −1 for a
    slot no pair holds.  Memoized on the layout."""
    memo = layout.__dict__.get("_grad_slot_map")
    if memo is not None:
        return memo
    P, L, K = layout.ports, layout.levels, layout.slots
    W = lane_width(P)
    E, H = W // 2 + 1, W // 2
    plan = rows_plan(layout).view(np.uint32).astype(np.int64)
    code = plan[:, :E * 32].reshape(L, E, 32)
    absent = plan[:, E * 32:E * 32 + 32]                       # (L, 32)
    parity = plan[:, -1] & 1
    i = np.arange(E)[None, :, None]
    own = np.where(parity[:, None, None] == 0, i < H, (i >= 1) & (i <= H))
    pair = ((absent[:, None, :] >> i) & 1) == 0
    cl, ei, t = np.nonzero(own & pair)
    c = code[cl, ei, t]
    stride = _map_stride(layout)
    out = np.full((L, stride), -1, dtype=np.int64)
    slot = c & ((1 << SLOT_BITS) - 1)
    if (np.bincount(cl * stride + slot, minlength=L * stride) > 1).any():
        raise AssertionError("two pairs of a level share a slot")
    neg = ((c >> SIGN_SHIFT) & 3) == 2
    out[cl, slot] = term_word(W, ei, t) + np.where(neg, MAP_NEG, 0)
    out = out.astype(np.int32)
    object.__setattr__(layout, "_grad_slot_map", out)
    return out


def _map_tensor(layout: ph_lib.MeshLayout,
                device: torch.device) -> torch.Tensor:
    memo = layout.__dict__.setdefault("_grad_slot_map_tensors", {})
    if device not in memo:
        memo[device] = torch.as_tensor(grad_slot_map(layout), device=device)
    return memo[device]


def grad_rows_config(layout: ph_lib.MeshLayout, S: int, rows: int,
                     sms: int) -> tuple:
    """The warp-rows backward's launch: (W, rows per warp R, warps per
    block, block columns).  A warp holds y and g of R rows, 2·R·W
    registers a thread: R = 2 where the grid keeps ``ROWS_FILL_WARPS``
    warps a multiprocessor, else 1 (at onn's hidden layer, 4300 rows of
    1024 ports, R = 2 in blocks of 8 warps beat R = 1 in 4 or 8 and R = 2
    in 4; tools/mesh_rows_grad.py).  A block takes one row tile of
    warps·R rows and writes its column's partials once, so more warps a
    block mean fewer columns and less scratch: as many as give every
    multiprocessor a block, from ``GRAD_ROWS_MIN_WARPS`` (a small batch
    is latency-bound: on layer 0's 100 rows 4 warps a block beat 1, 2 and
    8) up to the 512 threads (256 from W·R = 32) the registers allow and
    the warps whose terms fit shared memory beside the rings
    (``grad_rows_smem_bytes``: 8 at 1024 ports)."""
    W = lane_width(layout.ports)
    R = 2 if S * -(-rows // 2) >= ROWS_FILL_WARPS * sms else 1
    stride = _map_stride(layout)
    fit = ((SMEM_MAX_BYTES - grad_rows_smem_bytes(W, 0, stride))
           // (grad_rows_smem_bytes(W, 1, stride)
               - grad_rows_smem_bytes(W, 0, stride)))
    most = min((256 if W * R >= 32 else 512) // 32, fit)
    warps = min(most, max(GRAD_ROWS_MIN_WARPS, -(-S * rows // (R * sms))))
    return W, R, warps, -(-rows // (warps * R))


def _map_stride(layout: ph_lib.MeshLayout) -> int:
    """The slot map's row: the slots rounded up to 4."""
    return -(-layout.slots // 4) * 4


GRAD_ROWS_RING = 3                 # the walk's ring: chunks of 128/W levels


def grad_rows_smem_bytes(W: int, warps: int, map_stride: int) -> int:
    """Shared memory of one warp-rows backward block asked for dphases: a
    ring of ``GRAD_ROWS_RING`` chunks of route A's records and the slot
    map, every warp's terms of a chunk (``128/W`` levels of ``(W/2 +
    1)·32`` each) twice (one chunk's summed while the next is walked),
    and the ring's barriers (``csrc/mesh_apply.cu::rows_grad_smem``)."""
    ring, stage = GRAD_ROWS_RING, 128 // W
    return 4 * stage * (ring * (record_floats(W) + map_stride)
                        + 2 * warps * (W // 2 + 1) * 32) + 8 * ring


def grad_scratch_bytes(layout: ph_lib.MeshLayout, S: int, rows: int,
                       sms: int) -> int:
    """Bytes of the warp-rows backward's scratch with dphases asked for:
    the block columns' partials ``(columns, S, levels, slots)`` where
    there is more than one column, and the prologue's records ``(S,
    levels, record_floats(W))``."""
    W, _, _, cols = grad_rows_config(layout, S, rows, sms)
    part = cols * S * layout.levels * layout.slots if cols > 1 else 0
    return 4 * (part + S * layout.levels * record_floats(W))


def densify_grad_smem_bytes(pm: ph_lib.PhotonicMatrix, save: bool) -> int:
    """Shared memory of one block of the grouped backward's block design
    for matrix ``pm``: four row buffers ``(in_dim, max(in_dim,
    out_dim))``, V's output rows, three phase tables and the cos and sin
    tables of the larger mesh, and with ``save`` each level's input of
    both meshes."""
    lu, lv = pm.layout_u, pm.layout_v
    phases = max(lu.levels * lu.slots, lv.levels * lv.slots)
    table = max(lu.levels * lu.ports, lv.levels * lv.ports)
    states = (lv.levels * pm.in_dim * pm.in_dim
              + lu.levels * pm.in_dim * pm.out_dim) if save else 0
    return 4 * (4 * pm.in_dim * max(pm.in_dim, pm.out_dim)
                + pm.in_dim * pm.in_dim + 3 * phases + 2 * table + states)


def densify_grad_saves(pm: ph_lib.PhotonicMatrix) -> bool:
    """Whether the grouped backward's block design keeps matrix ``pm``'s
    forward states (exact; every core matrix of ``PAPER_TONN_SPEC``: 17 KB
    at most) or recovers them level by level (``ref.mesh_reverse``).  The
    warp design keeps them all."""
    return densify_grad_smem_bytes(pm, True) <= SMEM_MAX_BYTES


GRAD_GROUP_DESIGNS = ("warp", "block")   # the grouped backward's designs


def _warp_row_warps(ports: int, rows: int) -> int:
    """Warps that hold ``rows`` rows of a mesh of at most 32 ports, ``32 //
    ports`` rows a warp (``csrc/mesh_apply.cu::warp_row_warps``)."""
    return -(-rows // (32 // ports))


def densify_grad_warps(matrices) -> int:
    """Warps a block of the grouped backward's warp design: enough for the
    rows of both meshes of every matrix (V's and U's ``in_dim`` rows, in
    lanes of V's and U's width): 8 at the paper's 16 x 4 and 4 x 16."""
    return max(max(_warp_row_warps(pm.in_dim, pm.in_dim),
                   _warp_row_warps(pm.out_dim, pm.in_dim))
               for pm in matrices)


def densify_grad_warp_smem_bytes(pm: ph_lib.PhotonicMatrix,
                                 threads: int) -> int:
    """Shared memory of one warp-design block for matrix ``pm`` at
    ``threads`` a block: both meshes' tables (cos, sin, partner and plan
    word ``(levels, ports)``, the effective phases ``(levels, slots)``),
    V's output rows, the gradient at U's input rows, each thread's input
    at every level of both meshes and each warp's phase gradients
    (``csrc/mesh_apply.cu::densify_grad_warp_smem``)."""
    lu, lv = pm.layout_u, pm.layout_v
    phases = lu.levels * lu.slots + lv.levels * lv.slots
    tables = 4 * (lv.levels * lv.ports + lu.levels * lu.ports) + phases
    return 4 * (tables + pm.in_dim * (pm.in_dim + pm.out_dim)
                + (lv.levels + lu.levels) * threads
                + threads // 32 * phases)


def densify_grad_design(matrices) -> str:
    """The grouped backward's design for a group: ``"warp"`` (rows in a
    warp's lanes, levels by shuffles; ``mesh_densify_grad_warp_kernel``)
    where every mesh is at most 32 ports wide and every matrix's block
    fits shared memory at ``densify_grad_warps`` warps — every core matrix
    the repo's configs build — else ``"block"``, the first design (one
    element a thread, a block barrier a level; ``mesh_densify_grad_
    kernel``), which also takes the matrices whose states do not fit a
    block (``densify_grad_saves``)."""
    if any(max(pm.in_dim, pm.out_dim) > 32 for pm in matrices):
        return "block"
    threads = 32 * densify_grad_warps(matrices)
    fits = all(densify_grad_warp_smem_bytes(pm, threads) <= SMEM_MAX_BYTES
               for pm in matrices)
    return "warp" if fits else "block"


def densify_smem_bytes(pm: ph_lib.PhotonicMatrix) -> int:
    """Shared memory of one grouped block for matrix ``pm``: two row
    buffers ``(in_dim, max(in_dim, out_dim))``, and for the larger of its
    meshes two phase tables ``(levels, slots)`` and the cos and sin tables
    ``(levels, ports)``."""
    lu, lv = pm.layout_u, pm.layout_v
    phases = max(lu.levels * lu.slots, lv.levels * lv.slots)
    table = max(lu.levels * lu.ports, lv.levels * lv.ports)
    return 4 * (2 * pm.in_dim * max(pm.in_dim, pm.out_dim) + 2 * phases
                + 2 * table)


# ctypes mirrors of the C structs in csrc/mesh_apply.cu (same field order
# and types, so the native alignment rules give the same layout; the
# launcher checks the size against the library's)

class _MeshSide(ctypes.Structure):
    _fields_ = [("phases", ctypes.c_void_p), ("gamma", ctypes.c_void_p),
                ("bias", ctypes.c_void_p), ("diag", ctypes.c_void_p),
                ("slot", ctypes.c_void_p), ("sign", ctypes.c_void_p),
                ("perm", ctypes.c_void_p), ("diag_stride_s", ctypes.c_int64),
                ("ports", ctypes.c_int), ("levels", ctypes.c_int),
                ("slots", ctypes.c_int), ("crosstalk", ctypes.c_int)]


class _MatrixDesc(ctypes.Structure):
    _fields_ = [("u", _MeshSide), ("v", _MeshSide),
                ("sigma", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("k", ctypes.c_int), ("save_states", ctypes.c_int)]


class _GroupOffsets(ctypes.Structure):
    """Where each matrix's gradients start in the grouped backward's
    output, in floats (``GroupOffsets``; the warp design reads it)."""
    _fields_ = [("grads", ctypes.c_int64 * MAX_GROUP)]


class MeshGroup(ctypes.Structure):
    """The grouped kernel's parameter: G matrix descriptors and the
    settings they share (stack size, DAC step, crosstalk κ)."""
    _fields_ = [("m", _MatrixDesc * MAX_GROUP), ("count", ctypes.c_int),
                ("stack", ctypes.c_int), ("dac_step", ctypes.c_float),
                ("dac", ctypes.c_int), ("kappa", ctypes.c_float),
                ("pad", ctypes.c_int)]


def _need(name: str, t: torch.Tensor, shape: tuple, device: torch.device):
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != shape or not t.is_contiguous()):
        raise ValueError(f"{name}: need a contiguous float32 {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _pack_side(side: _MeshSide, name: str, layout: ph_lib.MeshLayout,
               phases: torch.Tensor, diag: torch.Tensor, noise: dict | None,
               crosstalk: bool, S: int, device: torch.device) -> None:
    L, K, P = layout.levels, layout.slots, layout.ports
    _need(f"{name} phases", phases, (S, L, K), device)
    if diag.ndim == 2:
        _need(f"{name} diag", diag, (S, P), device)
    else:
        _need(f"{name} diag", diag, (P,), device)
    plan = ph_lib.mesh_plan_tensors(layout, device)
    side.phases, side.diag = phases.data_ptr(), diag.data_ptr()
    side.slot = plan["slot_i32"].data_ptr()
    side.sign = plan["sign"].data_ptr()
    side.perm = plan["perm"].data_ptr()
    side.diag_stride_s = P if diag.ndim == 2 else 0
    side.ports, side.levels, side.slots = P, L, K
    if noise is not None:
        _need(f"{name} gamma", noise["gamma"], (L, K), device)
        _need(f"{name} bias", noise["bias"], (L, K), device)
        side.gamma = noise["gamma"].data_ptr()
        side.bias = noise["bias"].data_ptr()
    side.crosstalk = int(noise is not None and crosstalk and K > 1)


def pack_group(matrices, params, noises, noise_model, quant,
               out: list) -> MeshGroup:
    """The grouped kernel's descriptors for ``mesh_densify_stacked``'s
    arguments, with ``out[g]`` the ``(S, out_dim, in_dim)`` core that
    matrix g is written to.  Checks every tensor (contiguous float32 on
    the first sigma's device, shapes of the matrix's layouts, one stack
    size S) and each block's shared memory; raises on anything the kernel
    cannot take.  Pure Python, so it runs on CPU tensors too; the wrapper
    alone requires the card."""
    G = len(matrices)
    if not 1 <= G <= MAX_GROUP or not len(params) == len(noises) == \
            len(out) == G:
        raise ValueError(f"{G} matrices with {len(params)} params, "
                         f"{len(noises)} noises and {len(out)} outputs; "
                         f"the kernel takes 1..{MAX_GROUP} of each")
    device = params[0]["sigma"].device
    S = params[0]["sigma"].shape[0] if params[0]["sigma"].ndim == 2 else 0
    if not 1 <= S < 2**31:
        raise ValueError(f"sigma shape {tuple(params[0]['sigma'].shape)}: "
                         "need a stack (S, k) of at least one entry")
    noisy = noise_model is not None and noise_model.enabled
    crosstalk = noisy and noise_model.crosstalk > 0.0
    grp = MeshGroup(count=G, stack=S)
    if quant is not None and quant.phases:
        grp.dac = 1
        grp.dac_step = 2.0 * math.pi / (1 << quant.phase_bits)
    if crosstalk:
        grp.kappa = noise_model.crosstalk
    for g, (pm, p, nz, w) in enumerate(zip(matrices, params, noises, out)):
        need = densify_smem_bytes(pm)
        if need > SMEM_MAX_BYTES:
            raise ValueError(
                f"a {pm.out_dim} x {pm.in_dim} photonic matrix needs {need} "
                f"B of shared memory per block; the card has "
                f"{SMEM_MAX_BYTES} B")
        d = grp.m[g]
        nz = nz if noisy else None
        _pack_side(d.u, f"matrix {g} u", pm.layout_u, p["phases_u"],
                   p["diag_u"], None if nz is None else nz["u"], crosstalk,
                   S, device)
        _pack_side(d.v, f"matrix {g} v", pm.layout_v, p["phases_v"],
                   p["diag_v"], None if nz is None else nz["v"], crosstalk,
                   S, device)
        _need(f"matrix {g} sigma", p["sigma"], (S, pm.k), device)
        _need(f"matrix {g} out", w, (S, pm.out_dim, pm.in_dim), device)
        d.sigma, d.out, d.k = p["sigma"].data_ptr(), w.data_ptr(), pm.k
    return grp


PARAM_KEYS = ("phases_u", "phases_v", "sigma", "diag_u", "diag_v")
TEMPLATES_KEPT = 8           # group templates kept on a group's first matrix


def _call_words() -> np.ndarray:
    """``(MAX_GROUP, 6)``: the 8-byte word of ``MeshGroup`` that holds
    matrix g's pointer to each per-call tensor, in ``PARAM_KEYS`` order and
    then ``out``."""
    u, v = _MatrixDesc.u.offset, _MatrixDesc.v.offset
    field = {"phases_u": u + _MeshSide.phases.offset,
             "phases_v": v + _MeshSide.phases.offset,
             "sigma": _MatrixDesc.sigma.offset,
             "diag_u": u + _MeshSide.diag.offset,
             "diag_v": v + _MeshSide.diag.offset}
    cols = np.array([field[k] for k in PARAM_KEYS] + [_MatrixDesc.out.offset])
    rows = MeshGroup.m.offset + ctypes.sizeof(_MatrixDesc) * np.arange(
        MAX_GROUP)
    return (rows[:, None] + cols[None, :]) // 8


_CALL_WORDS = _call_words()
_F32 = torch.float32


class GroupTemplate:
    """The descriptors of one grouped launch (``pack_group``) with their
    static half packed once: every mesh's plan pointers, ports, levels,
    slots, crosstalk flag, gamma and bias, each matrix's k, and for the
    backward its design, warps, saved states and its gradients' layout.
    ``fits`` checks a call's tensors and ``bind`` writes only their
    pointers: the five of ``PARAM_KEYS`` a matrix and its out (the
    forward's, from the base of its one output allocation) or dW (the
    backward's).

    ``kind`` is ``"forward"`` (``mesh_densify_stacked``) or
    ``"backward"`` (``mesh_densify_grad``).  It keeps the matrices, their
    layouts and the noise tensors it packed, so the identities that key it
    (``group_template``) stay theirs while it lives."""

    def __init__(self, kind: str, matrices, params, noises, noise_model,
                 quant, dW=None):
        G = len(matrices)
        sigma = params[0]["sigma"]
        S = sigma.shape[0] if sigma.ndim == 2 else 0
        self.device = sigma.device
        # Tensor.get_device(): the card's index, -1 on the CPU
        self.device_index = -1 if sigma.device.type == "cpu" else \
            sigma.get_device()
        # (S, out_dim, in_dim) a matrix for the forward; for the backward
        # [dphases_u, dphases_v, dsigma] a matrix, in the kernel's order
        shapes = ([(S, pm.out_dim, pm.in_dim) for pm in matrices]
                  if kind == "forward" else
                  [s for pm in matrices for s in (
                      (S, *pm.layout_u.phase_shape()),
                      (S, *pm.layout_v.phase_shape()), (S, pm.k))])
        sizes = [math.prod(s) for s in shapes]
        offsets = np.cumsum([0] + sizes[:-1])
        self.size = int(sum(sizes))
        self.views = [(s, torch.empty(s, device="meta").stride(), int(o))
                      for s, o in zip(shapes, offsets)]
        if kind == "forward":
            out = [torch.empty(s, device=self.device) for s in shapes]
            self.out_bytes = (4 * offsets).astype(np.uint64)
        else:
            out = dW
        self.grp = pack_group(matrices, params, noises, noise_model, quant,
                              out)
        self.kind = kind
        self.design = self.warps = None
        if kind == "backward":
            self.design = densify_grad_design(matrices)
            if self.design == "warp":
                self.warps = densify_grad_warps(matrices)
            self.offsets = _GroupOffsets()
            self.offsets.grads[:G] = [o for _, _, o in self.views[::3]]
            for g, pm in enumerate(matrices):
                save = densify_grad_saves(pm)
                self.grp.m[g].save_states = int(save)
                need = densify_grad_smem_bytes(pm, save)
                if need > SMEM_MAX_BYTES:
                    raise ValueError(
                        f"a {pm.out_dim} x {pm.in_dim} photonic matrix's "
                        f"backward needs {need} B of shared memory per "
                        f"block; the card has {SMEM_MAX_BYTES} B (ROADMAP "
                        "queue A, item 6c-3)")
        words = _CALL_WORDS[:G]
        self.shapes = [params[g][k].shape for g in range(G)
                       for k in PARAM_KEYS]
        if kind == "forward":
            self.index = words[:, :5].ravel()
            self.out_index = words[:, 5]
        else:
            self.shapes += [w.shape for w in dW]
            self.index = np.concatenate([words[:, :5].ravel(), words[:, 5]])
        self.words = np.frombuffer(self.grp, dtype=np.uint64)
        self.keep = (list(matrices), [(pm.layout_u, pm.layout_v)
                                      for pm in matrices],
                     [t for nz in noises for t in _noise_tensors(nz)])

    def fits(self, tensors: list) -> bool:
        """Whether a call's tensors — each matrix's five of ``PARAM_KEYS``
        in order, then (backward) every dW — fit the template: their
        number, and each one's device, dtype, shape and contiguity."""
        if [t.shape for t in tensors] != self.shapes:
            return False
        index = self.device_index
        for t in tensors:
            if (t.dtype is not _F32 or t.get_device() != index
                    or not t.is_contiguous()):
                return False
        return True

    def bind(self, tensors: list, base: int = 0) -> MeshGroup:
        """The descriptors with the pointers of a call's tensors, which
        ``fits`` has checked, and the forward's outputs at ``base`` (the
        address of its one output allocation)."""
        self.words[self.index] = [t.data_ptr() for t in tensors]
        if self.kind == "forward":
            self.words[self.out_index] = base + self.out_bytes
        return self.grp

    def outputs(self, flat: torch.Tensor) -> list:
        """The call's outputs as views of its one allocation ``flat``
        (``size`` floats)."""
        return [flat.as_strided(s, st, o) for s, st, o in self.views]


def _noise_tensors(nz) -> tuple:
    """A matrix's noise tensors in a fixed order (one None without
    noise)."""
    return (None,) if nz is None else (nz["u"]["gamma"], nz["u"]["bias"],
                                       nz["v"]["gamma"], nz["v"]["bias"])


def group_template(kind: str, matrices, params, noises, noise_model, quant,
                   tensors: list, dW=None) -> GroupTemplate:
    """The template of a grouped call (``GroupTemplate``), kept for
    (kind, matrices and their layouts, noise tensors, noise model, quant,
    stack shape, device), that ``tensors`` fit (``GroupTemplate.fits``).
    Templates live on the group's first matrix (at most
    ``TEMPLATES_KEPT``, the oldest dropped first), keyed by the
    identities of the objects they keep, so a key never outlives its
    objects.  A call repacks — a new template through ``pack_group``,
    which raises on whatever the kernel cannot take — when the key is new
    or a tensor does not fit: a new matrix, layout or noise tensor,
    another stack size, device, noise setting or diag shape.  Param
    tensors swapped for others of the same shape need no repack: a call
    writes its pointers (``GroupTemplate.bind``)."""
    noisy = noise_model is not None and noise_model.enabled
    sigma = params[0]["sigma"]
    key = [kind, sigma.shape, sigma.device,
           noise_model.crosstalk if noisy else None,
           quant.phase_bits if quant is not None and quant.phases else None,
           len(noises)]
    key += [id(o) for pm in matrices
            for o in (pm, pm.layout_u, pm.layout_v)]
    if noisy:
        key += [None if nz is None else id(t) for nz in noises
                for t in _noise_tensors(nz)]
    key = tuple(key)
    cache = matrices[0].__dict__.setdefault("_group_templates", {})
    tpl = cache.get(key)
    if tpl is not None and tpl.fits(tensors):
        return tpl
    tpl = GroupTemplate(kind, matrices, params, noises, noise_model, quant,
                        dW)
    if not tpl.fits(tensors):
        raise ValueError("the grouped call's tensors do not match its "
                         "matrices and params")
    cache.pop(key, None)
    while len(cache) >= TEMPLATES_KEPT:
        cache.pop(next(iter(cache)))
    cache[key] = tpl
    return tpl


@functools.cache
def _library():
    lib = _build.load_library("mesh_apply")
    lib.mesh_apply_launch.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 6 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_void_p]
    lib.mesh_apply_launch.restype = ctypes.c_int
    lib.mesh_stream_launch.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 7 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_void_p]
    lib.mesh_stream_launch.restype = ctypes.c_int
    lib.mesh_rows_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 8 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    lib.mesh_rows_launch.restype = ctypes.c_int
    lib.mesh_product_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 3 + [ctypes.c_int64, ctypes.c_void_p]
    lib.mesh_product_launch.restype = ctypes.c_int
    lib.mesh_product_grad_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    lib.mesh_product_grad_launch.restype = ctypes.c_int
    lib.mesh_densify_group_bytes.restype = ctypes.c_int
    if lib.mesh_densify_group_bytes() != ctypes.sizeof(MeshGroup):
        raise RuntimeError(
            f"MeshGroup is {ctypes.sizeof(MeshGroup)} B here and "
            f"{lib.mesh_densify_group_bytes()} B in csrc/mesh_apply.cu")
    lib.mesh_densify_launch.argtypes = [ctypes.POINTER(MeshGroup),
                                        ctypes.c_void_p]
    lib.mesh_densify_launch.restype = ctypes.c_int
    lib.mesh_densify_grad_launch.argtypes = [ctypes.POINTER(MeshGroup),
                                             ctypes.c_void_p, ctypes.c_void_p]
    lib.mesh_densify_grad_launch.restype = ctypes.c_int
    lib.mesh_densify_grad_warp_launch.argtypes = [
        ctypes.POINTER(MeshGroup), ctypes.POINTER(_GroupOffsets),
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.mesh_densify_grad_warp_launch.restype = ctypes.c_int
    lib.mesh_apply_grad_launch.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 7 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.mesh_apply_grad_launch.restype = ctypes.c_int
    lib.mesh_apply_grad_warp_launch.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int] * 10 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.mesh_apply_grad_warp_launch.restype = ctypes.c_int
    lib.mesh_rows_grad_launch.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 10 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.mesh_rows_grad_launch.restype = ctypes.c_int
    return lib


def _check_stacked(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                   diag: torch.Tensor, x: torch.Tensor) -> tuple:
    """(S, B) of a standalone call; raises on what neither design takes."""
    P, L = layout.ports, layout.levels
    if x.device.type != "cuda":
        raise ValueError(f"mesh_apply_stacked runs on CUDA tensors, "
                         f"got {x.device}")
    for name, t in (("phases", phases), ("diag", diag), ("x", x)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {x.device}, got "
                             f"{t.dtype} on {t.device}")
    if phases.ndim != 3 or tuple(phases.shape[1:]) != layout.phase_shape():
        raise ValueError(f"phases shape {tuple(phases.shape)} is not "
                         f"(S, {L}, {layout.slots})")
    S = phases.shape[0]
    if not 1 <= S <= MAX_STACK:
        raise ValueError(f"stack of {S} meshes; the kernel takes "
                         f"1..{MAX_STACK}")
    if diag.shape not in ((P,), (S, P)):
        raise ValueError(f"diag shape {tuple(diag.shape)} is neither "
                         f"({P},) nor ({S}, {P})")
    if x.shape[-1] != P or x.ndim not in (2, 3) or (
            x.ndim == 3 and x.shape[0] != S):
        raise ValueError(f"x shape {tuple(x.shape)} is neither (B, {P}) "
                         f"nor ({S}, B, {P})")
    if not (x.is_contiguous() and diag.is_contiguous()
            and phases.is_contiguous()):
        raise ValueError("mesh_apply_stacked needs a contiguous x, diag "
                         "and phases")
    B = x.shape[-2]
    if S * B * P >= 2**31:
        raise ValueError(f"{S} x {B} x {P} elements exceed the kernel's "
                         "int32 range")
    return S, B


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"mesh_apply_stacked ({what}) launch failed: "
                           f"CUDA error {err}")


def _count(design: str) -> None:
    mesh_apply_stacked.launches += 1
    mesh_apply_stacked.design_launches[design] += 1


def _rows(layout, phases, diag, x, y, S, B, transpose, identity) -> None:
    """Route A's prologue and kernel into y (S, B, P); x None with
    ``identity`` (B = P: row r is e_r)."""
    P, L = layout.ports, layout.levels
    W, R, nw = rows_config(layout, S, B, _sm_count(y.device))
    table = torch.empty((S, L, record_floats(W)), dtype=torch.float32,
                        device=y.device)
    x_ptr = 0 if x is None else x.data_ptr()
    x_stride = B * P if x is not None and x.ndim == 3 else 0
    err = _library().mesh_rows_launch(
        x_ptr, phases.data_ptr(), _plan_tensor(layout, y.device).data_ptr(),
        diag.data_ptr(), y.data_ptr(), table.data_ptr(), B, P, L,
        layout.slots, S, W, R, nw, x_stride, P if diag.ndim == 2 else 0,
        int(transpose), int(identity), _stream(y))
    _raise_on(err, "warp_rows")


def _route_checks(layout: ph_lib.MeshLayout, route: str) -> None:
    if route not in ("warp_rows", "dense"):
        return
    if not route_a_takes(layout):
        raise ValueError(f"the {route} route takes layouts of at most 1024 "
                         "ports whose levels pair adjacent wires of one "
                         "parity")
    if route == "dense" and layout.ports % 4:
        raise ValueError(f"the dense route needs ports % 4 == 0, got "
                         f"{layout.ports}")


def _launch(design: str, layout: ph_lib.MeshLayout, phases: torch.Tensor,
            diag: torch.Tensor, x: torch.Tensor, transpose: bool,
            keep: bool = False):
    """The forward by ``design``; with ``keep`` (route B) also its dense
    scratch M: (y, M)."""
    S, B = _check_stacked(layout, phases, diag, x)
    P = layout.ports
    _route_checks(layout, design)
    # the launch configuration raises before any allocation
    if design == "resident":
        rows = rows_per_block(layout)
    elif design == "owner_walk":
        rows = stream_rows(layout, S, max(B, 1), _sm_count(x.device))
    y = torch.empty((S, B, P), dtype=torch.float32, device=x.device)
    if B == 0:
        return y
    plan = ph_lib.mesh_plan_tensors(layout, x.device)
    x_stride = B * P if x.ndim == 3 else 0
    diag_stride = P if diag.ndim == 2 else 0
    with torch.cuda.device(x.device):
        if design == "resident":
            err = _library().mesh_apply_launch(
                x.data_ptr(), phases.data_ptr(), plan["slot_i32"].data_ptr(),
                plan["sign"].data_ptr(), plan["perm"].data_ptr(),
                diag.data_ptr(), y.data_ptr(), B, P, layout.levels,
                layout.slots, S, rows, x_stride, diag_stride, int(transpose),
                _stream(x))
        elif design == "owner_walk":
            owner = plan["owner"]
            err = _library().mesh_stream_launch(
                x.data_ptr(), phases.data_ptr(), plan["slot_i32"].data_ptr(),
                plan["sign"].data_ptr(), plan["perm"].data_ptr(),
                owner.data_ptr(), diag.data_ptr(), y.data_ptr(), B, P,
                layout.levels, layout.slots, owner.shape[1], S, rows,
                x_stride, diag_stride, int(transpose), _stream(x))
        elif design == "warp_rows":
            _rows(layout, phases, diag, x, y, S, B, transpose, False)
            err = 0
        else:
            # route B: each entry's mesh made dense by route A on the
            # identity feed (row i = mesh(e_i)), then y_s = x_s · M_s
            dense = torch.empty((S, P, P), dtype=torch.float32,
                                device=x.device)
            _rows(layout, phases, diag, None, dense, S, P, transpose, True)
            err = _library().mesh_product_launch(
                x.data_ptr(), dense.data_ptr(), y.data_ptr(), B, P, S,
                x_stride, _stream(x))
    _raise_on(err, design)
    _count(design)
    return (y, dense) if keep else y


def launch_resident(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                    diag: torch.Tensor, x: torch.Tensor,
                    transpose: bool = False) -> torch.Tensor:
    """``mesh_apply_stacked`` through the resident design; raises for a
    layout whose tables and one row do not fit a block."""
    return _launch("resident", layout, phases, diag, x, transpose)


def launch_warp_rows(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                     diag: torch.Tensor, x: torch.Tensor,
                     transpose: bool = False) -> torch.Tensor:
    """``mesh_apply_stacked`` through route A, bit-equal to the plain
    version; raises for a layout ``adjacent_pairs`` refuses or past 1024
    ports."""
    return _launch("warp_rows", layout, phases, diag, x, transpose)


def launch_dense(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                 diag: torch.Tensor, x: torch.Tensor,
                 transpose: bool = False) -> torch.Tensor:
    """``mesh_apply_stacked`` through route B: route A densifies each
    entry's mesh into an ``(S, P, P)`` scratch, a 3xTF32 tensor-core
    kernel multiplies (within the f32 bound of the plain version); raises
    where route A does or for ports not a multiple of 4."""
    return _launch("dense", layout, phases, diag, x, transpose)


def launch_dense_keep(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                      diag: torch.Tensor, x: torch.Tensor,
                      transpose: bool = False) -> tuple:
    """``launch_dense``, returning y and its dense scratch M ``(S, P, P)``
    (y_s = x_s·M_s; row i of M_s is the mesh on e_i): what the dense
    backward reads (``MeshApplyFn``).  The same launches and bits."""
    return _launch("dense", layout, phases, diag, x, transpose, keep=True)


def launch_owner_walk(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                      diag: torch.Tensor, x: torch.Tensor,
                      transpose: bool = False) -> torch.Tensor:
    """``mesh_apply_stacked`` through the owner walk (any layout one row of
    which fits a block)."""
    return _launch("owner_walk", layout, phases, diag, x, transpose)


def mesh_apply_stacked(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                       diag: torch.Tensor, x: torch.Tensor,
                       transpose: bool = False) -> torch.Tensor:
    """Kernel-backed ``core.photonic.mesh_apply_stacked``: phases
    ``(S, levels, slots)``, diag ``(P,)`` or ``(S, P)``, x ``(B, P)``
    shared or ``(S, B, P)`` → ``(S, B, P)``, all float32 on one card,
    through the design ``mesh_design`` picks for the layout and, for a
    wide one, the route ``wide_route`` picks for (layout, S, B)."""
    design = mesh_design(layout)
    if design == "wide":
        design = wide_route(layout, phases.shape[0], x.shape[-2])
    return _launch(design, layout, phases, diag, x, transpose)


mesh_apply_stacked.launches = 0
mesh_apply_stacked.design_launches = dict.fromkeys(DESIGNS, 0)


def mesh_densify_stacked(matrices, params, noises, noise_model=None,
                         quant=None) -> list:
    """Kernel-backed ``core.photonic.mesh_densify_stacked``: G photonic
    matrices densified in one launch.  ``params[g]`` holds matrix g's
    stacked phases ``(S, levels, slots)`` and sigma ``(S, k)`` and its
    diag buffers ``(P,)`` or ``(S, P)``; ``noises[g]`` its chip noise
    (or None), shared across the stack, applied when ``noise_model`` is
    enabled; ``quant`` with ``phase_bits`` snaps the commanded phases to
    the DAC grid first.  Returns ``(S, out_dim, in_dim)`` per matrix, each
    contiguous, views of one allocation.  The descriptors come from the
    group's template (``group_template``): a call writes only its
    tensors' pointers."""
    if not matrices:
        raise ValueError("mesh_densify_stacked: no matrices")
    device = params[0]["sigma"].device
    if device.type != "cuda":
        raise ValueError(f"mesh_densify_stacked runs on CUDA tensors, got "
                         f"{device}")
    tensors = [p[k] for p in params for k in PARAM_KEYS]
    tpl = group_template("forward", matrices, params, noises, noise_model,
                         quant, tensors)
    flat = torch.empty(tpl.size, dtype=torch.float32, device=device)
    grp = tpl.bind(tensors, flat.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().mesh_densify_launch(ctypes.byref(grp), stream)
    if err != 0:
        raise RuntimeError(f"mesh_densify_stacked launch failed: CUDA error "
                           f"{err}")
    mesh_densify_stacked.launches += 1
    return tpl.outputs(flat)


mesh_densify_stacked.launches = 0


# ---------------------------------------------------------------- backwards

def mesh_densify_grad(matrices, params, noises, noise_model, dW: list,
                      design: str | None = None) -> list:
    """The grouped backward: the gradients of ``mesh_densify_stacked(
    matrices, params, noises, noise_model)`` (no DAC snap) against the
    cores' gradients ``dW[g]`` ``(S, out_dim, in_dim)``, contiguous, in
    one launch through the design ``densify_grad_design`` picks for the
    group (``design`` forces one of ``GRAD_GROUP_DESIGNS``; ``"warp"``
    raises for a group it does not hold).  Returns ``[(dphases_u,
    dphases_v, dsigma)]`` per matrix, of the commanded phases (the noise
    model's transpose applied in the launch), views of one allocation.
    The descriptors come from the group's template (``group_template``).
    Raises for a matrix no block holds (ROADMAP item 6c-3)."""
    if not matrices:
        raise ValueError("mesh_densify_grad: no matrices")
    device = params[0]["sigma"].device
    if device.type != "cuda":
        raise ValueError(f"mesh_densify_grad runs on CUDA tensors, got "
                         f"{device}")
    tensors = [p[k] for p in params for k in PARAM_KEYS] + list(dW)
    tpl = group_template("backward", matrices, params, noises, noise_model,
                         None, tensors, dW)
    design = tpl.design if design is None else design
    if design not in GRAD_GROUP_DESIGNS or (design == "warp" and
                                            tpl.design != "warp"):
        raise ValueError(f"the grouped backward has no {design!r} design "
                         f"for this group (its design: {tpl.design!r})")
    flat = torch.empty(tpl.size, dtype=torch.float32, device=device)
    grp = tpl.bind(tensors)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if design == "warp":
            err = _library().mesh_densify_grad_warp_launch(
                ctypes.byref(grp), ctypes.byref(tpl.offsets),
                flat.data_ptr(), tpl.warps, stream)
        else:
            err = _library().mesh_densify_grad_launch(
                ctypes.byref(grp), flat.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mesh_densify_grad ({design}) launch failed: "
                           f"CUDA error {err}")
    mesh_densify_grad.launches += 1
    mesh_densify_grad.design_launches[design] += 1
    out = tpl.outputs(flat)
    return [tuple(out[i:i + 3]) for i in range(0, len(out), 3)]


mesh_densify_grad.design_launches = dict.fromkeys(GRAD_GROUP_DESIGNS, 0)
mesh_densify_grad.launches = 0


DENSE_GRAD_SPLIT_BLOCKS = 2      # the split dM product's blocks an SM


def dense_grad_splits(S: int, P: int, B: int, sms: int) -> tuple:
    """(splits, k tiles a split) of the dense backward's dM = xᵀ·dy: its
    ``S·⌈P/128⌉²`` output tiles (64 at 1024 ports) reduce over the B rows
    in k tiles of 32, so the k tiles are split until the grid holds about
    ``DENSE_GRAD_SPLIT_BLOCKS`` blocks an SM, every split at least one
    tile (at 1024 ports on 4300 rows: 4 splits of 34 tiles, 256
    blocks)."""
    tiles = S * (-(-P // 128)) ** 2
    ktiles = max(1, -(-B // 32))
    want = max(1, min(ktiles, DENSE_GRAD_SPLIT_BLOCKS * sms // tiles,
                      MAX_STACK // S))
    per = -(-ktiles // want)
    return -(-ktiles // per), per


def mesh_product_grad(dy: torch.Tensor, dense: torch.Tensor,
                      x: torch.Tensor | None, dx: torch.Tensor | None,
                      dM: torch.Tensor | None, splits: int = 1,
                      per_split: int | None = None) -> None:
    """The dense backward's products on the tensor cores, in one launch of
    ``mesh_product_grad_kernel`` (3xTF32): ``dx_s = dy_s·M_sᵀ`` into dx
    ``(S, B, P)`` and ``dM_s = x_sᵀ·dy_s`` into dM ``(S, P, P)``, either
    skipped (None; x too when dM is), from dy ``(S, B, P)``, M ``(S, P,
    P)`` and x ``(B, P)`` shared or ``(S, B, P)``.  dM's k tiles (of 32
    rows) split ``splits`` ways, ``per_split`` tiles each, the splits'
    partials summed in order.  Counts one launch a call
    (``mesh_product_grad.launches``)."""
    S, B, P = dy.shape
    per = -(-B // 32) if per_split is None else per_split
    part = (torch.empty((splits, S, P, P), dtype=torch.float32,
                        device=dy.device)
            if dM is not None and splits > 1 else None)
    err = _library().mesh_product_grad_launch(
        dy.data_ptr(), dense.data_ptr(),
        None if x is None else x.data_ptr(),
        None if dx is None else dx.data_ptr(),
        None if dM is None else dM.data_ptr(),
        None if part is None else part.data_ptr(), B, P, S,
        B * P if x is not None and x.ndim == 3 else 0, splits, per,
        _stream(dy))
    _raise_on(err, "dense backward products")
    mesh_product_grad.launches += 1


mesh_product_grad.launches = 0


def _rows_grad(layout, phases, diag, y, dy, dx, dph, transpose, S,
               B) -> int:
    """The warp-rows backward's launches (trig prologue, walk, the block
    columns' sum) from y and dy ``(S, B, P)`` into dx and dphases (either
    None); returns the CUDA error."""
    P, L, K = layout.ports, layout.levels, layout.slots
    W, R, warps, cols = grad_rows_config(layout, S, B, _sm_count(y.device))
    smap = _map_tensor(layout, y.device)
    part = (torch.empty((cols, S, L, K), dtype=torch.float32,
                        device=y.device)
            if dph is not None and cols > 1 else None)
    table = torch.empty((S, L, record_floats(W)), dtype=torch.float32,
                        device=y.device)
    return _library().mesh_rows_grad_launch(
        y.data_ptr(), dy.data_ptr(), phases.data_ptr(),
        _plan_tensor(layout, y.device).data_ptr(), smap.data_ptr(),
        diag.data_ptr(), None if dx is None else dx.data_ptr(),
        None if dph is None else dph.data_ptr(),
        None if part is None else part.data_ptr(), table.data_ptr(),
        B, P, L, K, smap.shape[1], S, W, R, warps, cols,
        P if diag.ndim == 2 else 0, int(transpose), _stream(y))


def _dense_grad(layout, phases, diag, x, dense, dy, transpose, need_dx,
                need_dphases) -> tuple:
    """The dense backward (``mesh_apply_stacked_grad`` given x and M)."""
    S, B = _check_stacked(layout, phases, diag, x)
    P, L, K = layout.ports, layout.levels, layout.slots
    _route_checks(layout, "dense")
    _need("the dense scratch M", dense, (S, P, P), x.device)
    _need("dy", dy, (S, B, P), x.device)
    if not (need_dx or need_dphases):
        raise ValueError("mesh_apply_stacked_grad: neither dx nor dphases "
                         "asked for")
    sms = _sm_count(x.device)
    splits, per = dense_grad_splits(S, P, B, sms)
    dx = torch.empty((S, B, P), dtype=torch.float32, device=x.device) \
        if need_dx else None
    dph = torch.empty((S, L, K), dtype=torch.float32, device=x.device) \
        if need_dphases else None
    # dx_s = dy_s·M_sᵀ and dM_s = x_sᵀ·dy_s in one launch, then M's rows
    # walked back from dM for dphases
    dM = torch.empty_like(dense) if need_dphases else None
    with torch.cuda.device(x.device):
        mesh_product_grad(dy, dense, x, dx, dM, splits, per)
        if need_dphases:
            _raise_on(_rows_grad(layout, phases, diag, dense, dM, None, dph,
                                 transpose, S, P), "dense backward walk")
    mesh_apply_stacked_grad.launches += 1
    mesh_apply_stacked_grad.design_launches["dense"] += 1
    return dx, dph


def mesh_apply_stacked_grad(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                            diag: torch.Tensor, y: torch.Tensor | None,
                            dy: torch.Tensor, transpose: bool = False,
                            need_dx: bool = True, need_dphases: bool = True,
                            *, x: torch.Tensor | None = None,
                            dense: torch.Tensor | None = None) -> tuple:
    """The backward of ``mesh_apply_stacked``: the gradient at x as
    ``(S, B, P)`` (a shared x's is their sum over S, which the caller
    takes) and at the phases, ``(S, levels, slots)``, against the
    gradient dy ``(S, B, P)`` at its output; either may be skipped
    (None).  Handed route B's x and dense scratch M ``(S, P, P)``
    (``launch_dense_keep``; y unused), the ``"dense"`` design: dx =
    dy·Mᵀ and dM = xᵀ·dy on the tensor cores in one launch
    (``mesh_product_grad``; within the f32 bound of the plain version,
    not bit-equal), then the
    warp-rows backward on M's P identity rows (y := M, dy := dM) for
    dphases.  Handed y, the design ``grad_design`` picks from the layout
    alone: the resident backward, by the design ``resident_grad_design``
    picks (``"warp"``, one launch, or with many block columns a second
    that sums them; ``"block"``, a launch and, over several block columns,
    the sum's; ``_forced_resident`` forces one for measurements and card
    tests), or the warp-rows backward for
    route A's layouts (a trig prologue, the walk, and over several block
    columns the sum of their partials).  All contiguous float32 on one
    card.
    Raises, naming item 6c-3, for the owner walk's layouts, before any
    allocation."""
    if dense is not None:
        return _dense_grad(layout, phases, diag, x, dense, dy, transpose,
                           need_dx, need_dphases)
    S, B = _check_stacked(layout, phases, diag, y)
    P, L, K = layout.ports, layout.levels, layout.slots
    if y.ndim != 3 or tuple(dy.shape) != tuple(y.shape) or \
            dy.dtype != torch.float32 or dy.device != y.device or \
            not dy.is_contiguous():
        raise ValueError(f"y and dy: need contiguous float32 ({S}, B, {P}) "
                         f"on one card, got {tuple(y.shape)} and "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if not (need_dx or need_dphases):
        raise ValueError("mesh_apply_stacked_grad: neither dx nor dphases "
                         "asked for")
    design = _grad_design_or_raise(layout)    # before any allocation
    if _RESIDENT_FORCED is not None and design != "resident":
        raise ValueError(f"a {P}-port mesh takes the {design} backward, "
                         "not the resident one")
    res = (resident_grad_design(layout, _RESIDENT_FORCED)
           if design == "resident" else None)
    sms = _sm_count(y.device)
    dx = torch.empty_like(y) if need_dx else None
    dph = None
    if need_dphases:
        # the block design adds into dphases; the others write every slot
        dph = (torch.zeros if res == "block" or B == 0
               else torch.empty)((S, L, K), dtype=torch.float32,
                                 device=y.device)
    if B == 0:
        return dx, dph
    with torch.cuda.device(y.device):
        if res is not None:
            err = _resident_grad(layout, res, phases, diag, y, dy, dx, dph,
                                 transpose, S, B, sms)
        else:
            err = _rows_grad(layout, phases, diag, y, dy, dx, dph,
                             transpose, S, B)
    _raise_on(err, f"{design} backward ({res})" if res else
              f"{design} backward")
    mesh_apply_stacked_grad.launches += 1
    mesh_apply_stacked_grad.design_launches[design] += 1
    if res is not None:
        mesh_apply_stacked_grad.resident_launches[res] += 1
    return dx, dph


mesh_apply_stacked_grad.launches = 0
mesh_apply_stacked_grad.design_launches = dict.fromkeys(GRAD_DESIGNS, 0)
mesh_apply_stacked_grad.resident_launches = dict.fromkeys(
    RESIDENT_GRAD_DESIGNS, 0)


_RESIDENT_FORCED = None     # a resident design forced (_forced_resident)


@contextlib.contextmanager
def _forced_resident(design: str):
    """Within the block, ``mesh_apply_stacked_grad`` takes the resident
    ``design`` (one of ``RESIDENT_GRAD_DESIGNS``) for every layout whose
    backward is the resident one, and raises for any other layout, or
    where ``resident_grad_design`` refuses the design.  For measuring the
    designs in turns and for the card tests; no path of the port sets
    it."""
    global _RESIDENT_FORCED
    if design not in RESIDENT_GRAD_DESIGNS:
        raise ValueError(f"no resident design {design!r}")
    keep, _RESIDENT_FORCED = _RESIDENT_FORCED, design
    try:
        yield
    finally:
        _RESIDENT_FORCED = keep


def _tickets(device: torch.device, stream: int, S: int) -> torch.Tensor:
    """The warp design's fold tickets for launches on ``stream`` (its
    handle) of ``device``, one int32 an entry, zero between launches (the
    last block of an entry resets its own), at least S of them: allocated
    once a stream, and anew only for a larger stack.  Keyed by the stream,
    so each stream's launches, which it runs in turn, are the only ones to
    share a buffer."""
    key = (device, stream)
    have = _TICKETS.get(key)
    if have is None or have.numel() < S:
        have = torch.zeros(max(S, 64), dtype=torch.int32, device=device)
        _TICKETS[key] = have
    return have


_TICKETS: dict = {}


def _resident_grad(layout, res, phases, diag, y, dy, dx, dph, transpose, S,
                   B, sms) -> int:
    """The resident backward's launch by design ``res`` from y and dy
    ``(S, B, P)`` into dx and dphases (either None); returns the CUDA
    error."""
    P, L, K = layout.ports, layout.levels, layout.slots
    plan = ph_lib.mesh_plan_tensors(layout, y.device)
    if res == "warp":
        pairs, _, warps, cols, per, chunk, fold = resident_grad_warp_config(
            layout, S, B, sms)
    else:
        rows = grad_rows_per_block(layout)
        cols = grad_columns(S, -(-B // rows), sms)
    part = (torch.empty((cols, S, L, K), dtype=torch.float32,
                        device=y.device)
            if dph is not None and cols > 1 else None)
    ptrs = (y.data_ptr(), dy.data_ptr(), phases.data_ptr(),
            plan["slot_i32"].data_ptr(), plan["sign"].data_ptr(),
            plan["perm"].data_ptr(), diag.data_ptr(),
            None if dx is None else dx.data_ptr(),
            None if dph is None else dph.data_ptr(),
            None if part is None else part.data_ptr())
    stride = P if diag.ndim == 2 else 0
    if res == "warp":
        tickets = (_tickets(y.device, _stream(y), S).data_ptr()
                   if fold and part is not None else None)
        return _library().mesh_apply_grad_warp_launch(
            *ptrs, tickets, B, P, L, K, S, warps, cols, per, chunk,
            int(pairs), stride, int(transpose), _stream(y))
    return _library().mesh_apply_grad_launch(
        *ptrs, B, P, L, K, S, rows, cols, stride, int(transpose),
        _stream(y))


class MeshApplyFn(torch.autograd.Function):
    """``mesh_apply_stacked`` under autograd: the forward launch (any
    design or route), and ``mesh_apply_stacked_grad`` for what
    ``ctx.needs_input_grad`` asks (x, the phases), by the design
    ``grad_design`` picks for the forward's route.  A route-B forward
    saves x and its dense scratch M (``launch_dense_keep``), and its
    backward is the dense one; any other saves the output, not x, and
    its backward recovers each level's input from it."""

    @staticmethod
    def forward(ctx, layout, transpose, phases, diag, x):
        phases, diag, x = (t.contiguous() for t in (phases, diag, x))
        ctx.layout, ctx.transpose, ctx.x_shared = layout, transpose, \
            x.ndim == 2
        ctx.dense = grad_design(layout, phases.shape[0],
                                x.shape[-2]) == "dense"
        if ctx.dense:
            y, dense = launch_dense_keep(layout, phases, diag, x, transpose)
            ctx.save_for_backward(phases, diag, x, dense)
        else:
            y = mesh_apply_stacked(layout, phases, diag, x, transpose)
            ctx.save_for_backward(phases, diag, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        phases, diag, *kept = ctx.saved_tensors
        need_ph, need_diag, need_x = ctx.needs_input_grad[2:]
        if need_diag:
            raise ValueError("the mesh kernels take no gradient of the ±1 "
                             "diag buffers")
        if not (need_ph or need_x):
            return (None,) * 5
        if ctx.dense:
            dx, dph = mesh_apply_stacked_grad(
                ctx.layout, phases, diag, None, dy.contiguous(),
                ctx.transpose, need_x, need_ph, x=kept[0], dense=kept[1])
        else:
            dx, dph = mesh_apply_stacked_grad(
                ctx.layout, phases, diag, kept[0], dy.contiguous(),
                ctx.transpose, need_x, need_ph)
        if dx is not None and ctx.x_shared:
            dx = dx[0] if dx.shape[0] == 1 else dx.sum(0)
        return None, None, dph, None, dx


def apply_autograd(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                   diag: torch.Tensor, x: torch.Tensor,
                   transpose: bool = False) -> torch.Tensor:
    """``mesh_apply_stacked`` where autograd needs its backward: through
    ``MeshApplyFn``.  Raises before any launch where the diag buffer
    requires grad, or where no backward holds the layout (item 6c-3)."""
    _grad_design_or_raise(layout)
    if diag.requires_grad:
        raise ValueError("the mesh kernels take no gradient of the ±1 diag "
                         "buffers (TensorPinn.trainable_mask leaves them "
                         "out)")
    return MeshApplyFn.apply(layout, transpose, phases, diag, x)


class MeshDensifyFn(torch.autograd.Function):
    """``mesh_densify_stacked`` under autograd: the grouped forward launch
    and the grouped backward (``mesh_densify_grad``) for the phases and
    sigma ``ctx.needs_input_grad`` asks for.  The tensors come flat, five
    a matrix in ``PARAM_KEYS`` order; the noise rides along untracked."""

    @staticmethod
    def forward(ctx, matrices, noises, noise_model, *flat):
        flat = [t.contiguous() for t in flat]
        params = [dict(zip(PARAM_KEYS, flat[i:i + 5]))
                  for i in range(0, len(flat), 5)]
        ctx.matrices, ctx.noises, ctx.noise_model = matrices, noises, \
            noise_model
        ctx.save_for_backward(*flat)
        return tuple(mesh_densify_stacked(matrices, params, noises,
                                          noise_model))

    @staticmethod
    def backward(ctx, *dW):
        flat = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        out = [None] * len(flat)
        if any(need):
            params = [dict(zip(PARAM_KEYS, flat[i:i + 5]))
                      for i in range(0, len(flat), 5)]
            grads = mesh_densify_grad(ctx.matrices, params, ctx.noises,
                                      ctx.noise_model,
                                      [d.contiguous() for d in dW])
            for g, trio in enumerate(grads):
                for j, t in enumerate(trio):
                    if need[5 * g + j]:
                        out[5 * g + j] = t
        return (None, None, None, *out)


def densify_autograd(matrices, params, noises, noise_model=None,
                     quant=None) -> list:
    """``mesh_densify_stacked`` where autograd needs its backward: through
    ``MeshDensifyFn``.  Raises before any launch for what the backward
    does not take: DAC phase snapping (quantization-aware BP is ROADMAP
    item 11), a diag buffer or noise tensor that requires grad."""
    if quant is not None and quant.phases:
        raise ValueError("the grouped densification has no gradient through "
                         "DAC-snapped phases: quantization-aware BP is "
                         "ROADMAP queue A, item 11")
    for g, (p, nz) in enumerate(zip(params, noises, strict=True)):
        fixed = [p[k] for k in ph_lib.PHOTONIC_BUFFER_KEYS]
        fixed += [] if nz is None else [t for side in nz.values()
                                        for t in side.values()]
        if any(t.requires_grad for t in fixed):
            raise ValueError(f"matrix {g}: a diag buffer or a noise tensor "
                             "requires grad; the grouped backward gives the "
                             "phases and sigma only")
    flat = [p[k] for p in params for k in PARAM_KEYS]
    return list(MeshDensifyFn.apply(list(matrices), list(noises),
                                    noise_model, *flat))
