"""Wrapper of the hand-written CUDA flash-attention kernel
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
D 128) that is ~0.07 ms, set by the FLOPs.  The kernel is the simple
design (float FMAs on the CUDA cores, one 64-query tile per block, one
64-key K/V tile at a time in shared memory); see the source.

The wrapper checks what the kernel takes and raises on anything else:
float32 or bfloat16, all three of one type on one card, head dims 1..128
(every config of the repo: 16–128).  It makes q, k and v contiguous
(``attention_fwd``'s transposes give strided views), allocates the output,
launches on the current stream without synchronizing, and counts its
launches in ``flash_attention.launches``.  It never falls back to the
plain version (``kernels.ref.attention_ref``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "MAX_HEAD_DIM", "DTYPES"]

MAX_HEAD_DIM = 128                 # the kernel's widest padded head dim
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65_535               # heads and batch ride grid.y and grid.z


@functools.cache
def _launcher():
    fn = _build.load_library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KH, Sk, D), H % KH == 0 → (B, H, Sq, D)
    in q's dtype, on the card.  ``window``: query i (at ``i + Sk − Sq``)
    sees keys in ``(i_abs − window, i_abs]``; ``scale`` defaults to
    ``1/sqrt(D)``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: need {q.dtype} on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, H, Sq, D) and k, v (B, KH, Sk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads are not a multiple of {KH} KV "
                         "heads")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D}; the kernel takes 1..{MAX_HEAD_DIM}")
    if B > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"batch {B} or heads {H} over the grid's "
                         f"{MAX_GRID_YZ}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    # a window at least Sk wide masks nothing, and one below −(Sq + Sk)
    # masks everything: clamping keeps the kernel's int arithmetic small
    has_window = window is not None
    win = min(max(int(window), -(Sq + Sk)), Sk) if has_window else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), DTYPES[q.dtype], B, H, KH, Sq, Sk,
                          D, float(scale), int(causal), int(has_window), win,
                          stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
