"""Wrappers of the hand-written CUDA mesh kernels (``csrc/mesh_apply.cu``).

Replace the Pallas kernel ``repro/kernels/mesh_apply.py::
mesh_apply_stacked_pallas`` (its ``pallas_call`` at line 136), which ran
S stacked MZI meshes of one layout on x shared across the stack or per
entry, with trig tables built outside the kernel, and the JAX package's
jnp gather scan that took the meshes too wide for it
(``repro/kernels/ops.py:139-140``).  Here every block builds its own trig
from the phases and the layout's plan (``core.photonic.mesh_plan_tensors``),
so a call is one allocation and one launch.  Two entries:

  * ``mesh_apply_stacked`` — the standalone mesh, kernel-backed
    ``core.photonic.mesh_apply_stacked`` (``PhotonicMatrix.apply`` and
    ``apply_stacked``) in two designs, which ``mesh_design`` picks from the
    layout alone: ``resident`` (``launch_resident``) holds the layout's
    trig and perm tables in shared memory, up to ~138 ports of a
    rectangular mesh; ``streamed`` (``launch_streamed``) holds only its
    rows and reads each level's phases and plan from device memory, for
    any wider layout (onn's 1024-port meshes).  Both round every operation
    as the plain version does, so they agree with it, and with each other,
    bit for bit.
  * ``mesh_densify_stacked`` — ``PhotonicMatrix.to_dense_stacked`` of G
    matrices in one launch, DAC snap and noise model included, each
    written as its TT core: the ZO step's whole densification
    (``TensorPinn.prepare_params_stacked``).  Its G descriptors go to the
    kernel by value (``MeshGroup``, a ctypes mirror of the C struct), so
    the launch copies nothing from the host.

The TPU's one-hot permutation matmul (``mesh_perm_onehot``) has no
counterpart: the kernels read ``x[perm[c, w]]`` from shared memory.  The
TPU's size limits assumed VMEM; here a block holds its tables and buffers
in at most Hopper's 232,448 bytes of shared memory (``smem_bytes``,
``stream_smem_bytes``, ``densify_smem_bytes``), and what no design holds
raises — there is no plain fallback on the card.

Each wrapper checks what its kernel takes and raises on anything else,
allocates the output, launches on the current stream without
synchronizing, and counts its launches (``<wrapper>.launches``; per design
``mesh_apply_stacked.design_launches``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core import photonic as ph_lib
from repro_torch.kernels import _build
from repro_torch.kernels.tt_contract import SMEM_MAX_BYTES

__all__ = ["mesh_apply_stacked", "launch_resident", "launch_streamed",
           "mesh_design", "DESIGNS", "mesh_densify_stacked", "smem_bytes",
           "rows_per_block", "stream_smem_bytes", "stream_rows",
           "densify_smem_bytes", "MeshGroup", "pack_group", "MAX_GROUP"]

MAX_ROW_ELEMENTS = 1024            # rows per block × ports, at most
MAX_STACK = 65_535                 # the standalone grid's y extent
MAX_GROUP = 20                     # kMaxGroup: matrices per grouped launch
DESIGNS = ("resident", "streamed")
ROT_BYTES = 24                     # sizeof(Rot): a streamed owner's entry


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
    (``rows_per_block``), else ``"streamed"``."""
    fits = smem_bytes(layout.ports, layout.levels, 1) <= SMEM_MAX_BYTES
    return "resident" if fits else "streamed"


def stream_smem_bytes(ports: int, items: int, rows: int) -> int:
    """Shared memory of one streamed block: two owner lists of ``items``
    entries (the level being applied and the next) and ``rows`` rows plus
    the diag row."""
    return 2 * ROT_BYTES * items + 4 * (rows + 1) * ports


def stream_rows(layout: ph_lib.MeshLayout, stack: int, batch: int,
                sms: int) -> int:
    """Rows of x one streamed block holds: as many as shared memory takes,
    or fewer so that the grid's waves over ``sms`` multiprocessors come
    out whole (a small batch then spreads over every SM instead of a few
    full blocks).  Raises for a layout one row of which does not fit."""
    P = layout.ports
    items = ph_lib.mesh_owner_plan(layout).shape[1]
    fit = (SMEM_MAX_BYTES - stream_smem_bytes(P, items, 0)) // (4 * P)
    if fit < 1:
        raise ValueError(
            f"a {P}-port mesh needs {stream_smem_bytes(P, items, 1)} B of "
            f"shared memory per streamed block; the card has "
            f"{SMEM_MAX_BYTES} B")
    tiles = -(-batch // fit)
    waves = -(-stack * tiles // sms)
    tiles = min(batch, waves * sms // stack)
    return -(-batch // tiles)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
                ("k", ctypes.c_int), ("pad", ctypes.c_int)]


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
    lib.mesh_densify_group_bytes.restype = ctypes.c_int
    if lib.mesh_densify_group_bytes() != ctypes.sizeof(MeshGroup):
        raise RuntimeError(
            f"MeshGroup is {ctypes.sizeof(MeshGroup)} B here and "
            f"{lib.mesh_densify_group_bytes()} B in csrc/mesh_apply.cu")
    lib.mesh_densify_launch.argtypes = [ctypes.POINTER(MeshGroup),
                                        ctypes.c_void_p]
    lib.mesh_densify_launch.restype = ctypes.c_int
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


def _launch(design: str, layout: ph_lib.MeshLayout, phases: torch.Tensor,
            diag: torch.Tensor, x: torch.Tensor,
            transpose: bool) -> torch.Tensor:
    S, B = _check_stacked(layout, phases, diag, x)
    P = layout.ports
    # the launch configuration raises before any allocation
    rows = (rows_per_block(layout) if design == "resident"
            else stream_rows(layout, S, max(B, 1), _sm_count(x.device)))
    y = torch.empty((S, B, P), dtype=torch.float32, device=x.device)
    if B == 0:
        return y
    plan = ph_lib.mesh_plan_tensors(layout, x.device)
    x_stride = B * P if x.ndim == 3 else 0
    diag_stride = P if diag.ndim == 2 else 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if design == "resident":
            err = _library().mesh_apply_launch(
                x.data_ptr(), phases.data_ptr(), plan["slot_i32"].data_ptr(),
                plan["sign"].data_ptr(), plan["perm"].data_ptr(),
                diag.data_ptr(), y.data_ptr(), B, P, layout.levels,
                layout.slots, S, rows, x_stride, diag_stride, int(transpose),
                stream)
        else:
            owner = plan["owner"]
            err = _library().mesh_stream_launch(
                x.data_ptr(), phases.data_ptr(), plan["slot_i32"].data_ptr(),
                plan["sign"].data_ptr(), plan["perm"].data_ptr(),
                owner.data_ptr(), diag.data_ptr(), y.data_ptr(), B, P,
                layout.levels, layout.slots, owner.shape[1], S, rows,
                x_stride, diag_stride, int(transpose), stream)
    if err != 0:
        raise RuntimeError(f"mesh_apply_stacked ({design}) launch failed: "
                           f"CUDA error {err}")
    mesh_apply_stacked.launches += 1
    mesh_apply_stacked.design_launches[design] += 1
    return y


def launch_resident(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                    diag: torch.Tensor, x: torch.Tensor,
                    transpose: bool = False) -> torch.Tensor:
    """``mesh_apply_stacked`` through the resident design; raises for a
    layout whose tables and one row do not fit a block."""
    return _launch("resident", layout, phases, diag, x, transpose)


def launch_streamed(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                    diag: torch.Tensor, x: torch.Tensor,
                    transpose: bool = False) -> torch.Tensor:
    """``mesh_apply_stacked`` through the streamed design (any layout one
    row of which fits a block)."""
    return _launch("streamed", layout, phases, diag, x, transpose)


def mesh_apply_stacked(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                       diag: torch.Tensor, x: torch.Tensor,
                       transpose: bool = False) -> torch.Tensor:
    """Kernel-backed ``core.photonic.mesh_apply_stacked``: phases
    ``(S, levels, slots)``, diag ``(P,)`` or ``(S, P)``, x ``(B, P)``
    shared or ``(S, B, P)`` → ``(S, B, P)``, all float32 on one card,
    through the design ``mesh_design`` picks for the layout."""
    return _launch(mesh_design(layout), layout, phases, diag, x, transpose)


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
    contiguous, views of one allocation."""
    if not matrices:
        raise ValueError("mesh_densify_stacked: no matrices")
    device = params[0]["sigma"].device
    if device.type != "cuda":
        raise ValueError(f"mesh_densify_stacked runs on CUDA tensors, got "
                         f"{device}")
    S = params[0]["sigma"].shape[0]
    sizes = [S * pm.out_dim * pm.in_dim for pm in matrices]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    out = [w.view(S, pm.out_dim, pm.in_dim)
           for w, pm in zip(flat.split(sizes), matrices)]
    grp = pack_group(matrices, params, noises, noise_model, quant, out)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().mesh_densify_launch(ctypes.byref(grp), stream)
    if err != 0:
        raise RuntimeError(f"mesh_densify_stacked launch failed: CUDA error "
                           f"{err}")
    mesh_densify_stacked.launches += 1
    return out


mesh_densify_stacked.launches = 0
