"""Wrapper of the hand-written CUDA mesh kernel (``csrc/mesh_apply.cu``).

Replaces the Pallas kernel ``repro/kernels/mesh_apply.py::
mesh_apply_stacked_pallas`` (its ``pallas_call`` at line 136): S stacked
MZI meshes that share one layout, applied to x shared across the stack or
per entry.  It is the TONN hot path's densification engine: every step of
ZO training densifies all N+1 perturbed phase sets of each core mesh at
once (``PhotonicMatrix.to_dense_stacked``).

The trig tables come from ``core.photonic.mesh_gather_tables`` outside the
kernel, as in the JAX package.  The TPU's one-hot permutation matmul
(``mesh_perm_onehot``) has no counterpart: the kernel reads
``x[perm[c, w]]`` from shared memory with an int32 table.  The TPU's size
limits (``MESH_KERNEL_MAX_LEVELS``, ``MESH_KERNEL_MAX_ONEHOT_BYTES``)
assumed VMEM; here a block stages the tables, the diag row and two row
buffers in at most Hopper's 232,448 bytes of shared memory
(``smem_bytes``), and a layout that does not fit raises — there is no
plain fallback on the card.

The wrapper checks what the kernel takes and raises on anything else,
allocates the output, launches on the current stream without
synchronizing, and counts its launches in ``mesh_apply_stacked.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import photonic as ph_lib
from repro_torch.kernels import _build
from repro_torch.kernels.tt_contract import SMEM_MAX_BYTES

__all__ = ["mesh_apply_stacked", "smem_bytes", "rows_per_block"]

MAX_ROW_ELEMENTS = 1024            # rows per block × ports, at most
MAX_STACK = 65_535                 # the grid's y extent


def smem_bytes(ports: int, levels: int, rows: int) -> int:
    """Shared memory of one block: cos, sin and perm tables
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


@functools.cache
def _launcher():
    fn = _build.load_library("mesh_apply").mesh_apply_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mesh_apply_stacked(layout: ph_lib.MeshLayout, phases: torch.Tensor,
                       diag: torch.Tensor, x: torch.Tensor,
                       transpose: bool = False) -> torch.Tensor:
    """Kernel-backed ``core.photonic.mesh_apply_stacked``: phases
    ``(S, levels, slots)``, diag ``(P,)`` or ``(S, P)``, x ``(B, P)``
    shared or ``(S, B, P)`` → ``(S, B, P)``, all float32 on one card."""
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
    if not (x.is_contiguous() and diag.is_contiguous()):
        raise ValueError("mesh_apply_stacked needs a contiguous x and diag")
    rows = rows_per_block(layout)
    B = x.shape[-2]
    y = torch.empty((S, B, P), dtype=torch.float32, device=x.device)
    if B == 0:
        return y
    if S * B * P >= 2**31:
        raise ValueError(f"{S} x {B} x {P} elements exceed the kernel's "
                         "int32 range")
    cos, sin = ph_lib.mesh_gather_tables(layout, phases, transpose)
    cos, sin = cos.contiguous(), sin.contiguous()
    perm = ph_lib.mesh_plan_tensors(layout, x.device)[
        "perm_t" if transpose else "perm"]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                          perm.data_ptr(), diag.data_ptr(), y.data_ptr(),
                          B, P, L, S, rows, B * P if x.ndim == 3 else 0,
                          P if diag.ndim == 2 else 0, int(transpose), stream)
    if err != 0:
        raise RuntimeError(f"mesh_apply_stacked launch failed: CUDA error "
                           f"{err}")
    mesh_apply_stacked.launches += 1
    return y


mesh_apply_stacked.launches = 0
