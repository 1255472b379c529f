"""Wrapper of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention.cu``).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention`` (body ``_kernel``, ``pallas_call`` at line 114):
streaming-softmax attention that never materializes the (Sq × Sk) scores,
GQA by ``h // (H // KH)``, causal and sliding-window masks on absolute
positions (queries take the last Sq slots), zeros for a row that sees no
key.  The LM's prefill runs it once per layer (``models.layers.
attention_fwd`` through ``kernels.ops.attention``).

Bound on an H100: 4·D FLOPs per unmasked (q, k) pair at 989 TFLOP/s
(bf16 tensor cores), against q, k, v and the output moved once at
3.35 TB/s.  At qwen2.5-3b's 2048-token causal prefill (B 4, H 16, KH 2,
D 128) that is ~0.07 ms, set by the FLOPs.

The dtype picks the design (``DESIGNS``; see the source):

* bfloat16 — ``"wgmma"``: TMA feeds bf16 tiles to shared memory, both
  products run on the tensor cores, P split into two bf16 halves so the
  result stays within ``ref.attention_bound``.  q, k and v are read through
  TMA tensor maps built from the views' own strides (``tensor_map``), so
  ``attention_fwd``'s transposed views are not copied; a view that TMA
  cannot describe is made contiguous first.  The head dim must be a
  multiple of 8 (TMA's strides are multiples of 16 bytes).
* float32 — ``"simple"``: float FMAs on the CUDA cores (tests and the
  2-layer card-vs-CPU check); q, k and v are made contiguous.

The wrapper checks what the kernels take and raises on anything else:
float32 or bfloat16, all three of one type on one card, head dims 1..128
(every config of the repo: 16–128).  It allocates the output (contiguous),
launches on the current stream without synchronizing, and counts its
launches in ``flash_attention.launches`` and, per design, in
``flash_attention.design_launches``.  It never falls back to the other
design or to the plain version (``kernels.ref.attention_ref``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "tensor_map", "MAX_HEAD_DIM", "DESIGNS"]

MAX_HEAD_DIM = 128                 # the kernels' widest padded head dim
DESIGNS = {torch.bfloat16: "wgmma", torch.float32: "simple"}
MAX_GRID_YZ = 65_535               # the simple kernel's heads and batch
TMA_ALIGN = 16                     # bytes: TMA's base and stride unit
_MAP_LEN = 10                      # entries of a tensor-map description


@functools.cache
def _launchers():
    lib = _build.load_library("flash_attention")
    f32 = lib.flash_attention_f32_launch
    f32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                    + [ctypes.c_float] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    f32.restype = ctypes.c_int
    bf16 = lib.flash_attention_bf16_launch
    bf16.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                     + [ctypes.c_float] + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    bf16.restype = ctypes.c_int
    return f32, bf16


def _check_tma_head_dim(D: int) -> None:
    if D % 8:
        raise ValueError(f"bf16 head dim {D} is not a multiple of 8: TMA "
                         "needs every stride a multiple of 16 bytes")


def tensor_map(t: torch.Tensor) -> tuple | None:
    """The 4-D TMA tensor map over a bf16 view ``t`` of shape (B, X, S, D)
    without a copy, as the kernel's launcher takes it: dims innermost first
    (D, then the S, X and B axes in order of stride), their byte strides,
    and the map dim (1..3) of the S, X and B axes — 10 ints.  None where
    TMA cannot read the view as it is (last dim not contiguous, base or a
    stride not a multiple of 16 bytes, axes that overlap); the caller then
    makes it contiguous.  Axes of size 0 or 1 go last, with a stride that
    continues the others.  Raises on a head dim that is not a multiple of
    8, which no copy can fix."""
    B, X, S, D = t.shape
    _check_tma_head_dim(D)
    size = t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % TMA_ALIGN:
        return None
    # (axis, extent, stride in elements) of S, X and B
    axes = [(0, S, t.stride(2)), (1, X, t.stride(1)), (2, B, t.stride(0))]
    order = sorted((a for a in axes if a[1] > 1), key=lambda a: a[2])
    reach = D                          # elements spanned by the dims so far
    for _, extent, stride in order:
        if stride * size % TMA_ALIGN or stride < reach:
            return None
        reach = stride * extent
    order += [(axis, extent, reach) for axis, extent, _ in axes
              if extent <= 1]
    dims = [D] + [extent for _, extent, _ in order]
    strides = [stride * size for _, _, stride in order]
    pos = [1 + [a for a, _, _ in order].index(axis) for axis in range(3)]
    return tuple(dims + strides + pos)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: need {q.dtype} on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    if q.dtype not in DESIGNS:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, H, Sq, D) and k, v (B, KH, Sk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, D = q.shape
    KH = k.shape[1]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads are not a multiple of {KH} KV "
                         "heads")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D}; the kernel takes 1..{MAX_HEAD_DIM}")
    if DESIGNS[q.dtype] == "wgmma":
        _check_tma_head_dim(D)
    elif B > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"batch {B} or heads {H} over the grid's "
                         f"{MAX_GRID_YZ}")


def _map_of(t: torch.Tensor) -> tuple:
    """(tensor TMA reads, its ctypes map description): the view itself
    where ``tensor_map`` takes it, else a contiguous copy in fresh (aligned)
    memory."""
    desc = tensor_map(t)
    if desc is None:
        t = t.clone(memory_format=torch.contiguous_format)
        desc = tensor_map(t)
    return t, (ctypes.c_int64 * _MAP_LEN)(*desc)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KH, Sk, D), H % KH == 0 → (B, H, Sq, D)
    in q's dtype, on the card.  ``window``: query i (at ``i + Sk − Sq``)
    sees keys in ``(i_abs − window, i_abs]``; ``scale`` defaults to
    ``1/sqrt(D)``."""
    _check(q, k, v)
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    design = DESIGNS[q.dtype]
    if Sk == 0:                        # every row sees no key: zeros
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    # a window at least Sk wide masks nothing, and one below −(Sq + Sk)
    # masks everything: clamping keeps the kernel's int arithmetic small
    has_window = window is not None
    win = min(max(int(window), -(Sq + Sk)), Sk) if has_window else 0
    args = (B, H, KH, Sq, Sk, D, float(scale), int(causal), int(has_window),
            win)
    f32_launch, bf16_launch = _launchers()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if design == "wgmma":
            (q, q_map), (k, k_map), (v, v_map) = map(_map_of, (q, k, v))
            err = bf16_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), q_map, k_map, v_map, *args,
                              stream)
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            err = f32_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), *args, stream)
    if err >= 100_000:
        raise RuntimeError(f"flash_attention ({design}): CUDA refused "
                           f"a TMA tensor map: CUresult {err - 100_000}")
    if err != 0:
        raise RuntimeError(f"flash_attention ({design}) launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    flash_attention.design_launches[design] += 1
    return out


flash_attention.launches = 0
flash_attention.design_launches = dict.fromkeys(DESIGNS.values(), 0)
