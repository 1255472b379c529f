"""Spectral (FFT) derivative estimation: the third BP-free estimator.

``fd_estimate`` pays ``2A`` extra inferences a collocation point and
carries the 1/h² float32 noise floor; ``stein_estimate`` pays ``2S`` and
carries Monte-Carlo variance.  This estimator samples u on small per-axis
line grids through anchor points and recovers ∂_i u and ∂²_i u by a real
FFT along each line:

    û_m = rfft(u on the M-point line along axis i),   k̃_m = 2π m / W
    ∂_i u  = irfft( i·k̃ · û )     (Nyquist mode zeroed: an odd derivative)
    ∂²_i u = irfft( −k̃² · û )

exact for band-limited u.  The anchor sits at line index ``M//2``, so all A
partials are read off at the anchor and the residual is evaluated there.
A loss evaluation costs ``B·(A·(M−1) + 1)`` distinct rows (the anchor row
is shared by its A lines) against FD's ``B·(2A+1)``.

Periodization (``periodization=``):

  * ``"periodic"``: u is periodic with period W along each active axis;
    plain rfft, exact to f32 roundoff for trigonometric polynomials of
    maximum frequency < M/2;
  * ``"window"``: u lives on a non-periodic box.  The least-squares
    quadratic through the samples is subtracted and differentiated
    analytically (locally quadratic u is exact), and the residue is
    multiplied by a C^∞ bump window, 1 on a plateau around the anchor and
    0 at the segment ends; w' = w'' = 0 at the anchor, so the windowed
    residue's derivatives there are the residue's own.  ``WINDOWED_FLOOR``
    is the documented error at M ≥ 8 on O(1) smooth functions;
  * a per-axis tuple mixes the two (ns-2d's periodic space, windowed time).

A closed-form ansatz term with a kink (HJB's ‖x‖₁) would poison the
windowed FFT; problems remove it through the ``spectral_carrier`` hook
(``repro_torch.pde.base``): the FFT sees u − β and β's exact derivatives
are added back.

The FFT is ``torch.fft.rfft`` / ``irfft`` (cuFFT on the card, as the JAX
package leaves its ``jnp.fft`` to XLA; the TPU kernels have none), and it
is differentiable, so the BP baselines take the spectral loss by autograd.
``spectral_derivs_ref`` is the reference's numpy float64 oracle, copied
as it is.

Port of ``repro.core.spectral``.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core import stein

__all__ = ["line_offsets", "spectral_window", "spectral_line_rows",
           "line_vals_from_rows_vals", "spectral_derivs",
           "spectral_derivs_ref", "estimate_from_line_vals",
           "spectral_estimate", "num_spectral_inferences",
           "WINDOWED_FLOOR"]

# documented accuracy floor of the windowed (detrend + taper) path on O(1)
# smooth non-periodic functions at the default plateau and any M ≥ 8: max
# |error| of grad and hess_diag at the anchor
WINDOWED_FLOOR = 3e-2


def num_spectral_inferences(n_anchors: int, n_active: int,
                            points: int) -> int:
    """Distinct model rows a spectral loss evaluation: the anchor row is
    shared by its A lines, so B anchors cost B·(A·(M−1)+1), against FD's
    B·(2A+1) (``stein.num_fd_inferences``)."""
    return n_anchors * (n_active * (points - 1) + 1)


def line_offsets(points: int, extent: float, device=None) -> torch.Tensor:
    """(M,) signed offsets along a line, the anchor at index M//2, uniform
    spacing extent/M (one FFT period of length ``extent``)."""
    c = points // 2
    return (torch.arange(points, device=device) - c) * (extent / points)


@functools.lru_cache(maxsize=None)
def _window_np(points: int, plateau: float) -> np.ndarray:
    """C^∞ bump window over line indices: 1 on the central ``plateau``
    fraction, a smooth exp-step taper to 0 at the segment ends."""
    c = points // 2
    theta = np.abs((np.arange(points) - c) / points)   # ∈ [0, 0.5)
    r0, r1 = 0.5 * plateau, 0.5
    t = np.clip((theta - r0) / (r1 - r0), 0.0, 1.0)

    def h(y):
        out = np.zeros_like(y)
        pos = y > 0
        out[pos] = np.exp(-1.0 / y[pos])
        return out

    w = h(1.0 - t) / (h(1.0 - t) + h(t))
    return w.astype(np.float32)


def spectral_window(points: int, plateau: float = 0.25) -> torch.Tensor:
    """The ``"window"`` periodization's taper (see ``_window_np``)."""
    return torch.tensor(_window_np(points, float(plateau)))


@functools.lru_cache(maxsize=None)
def _detrend_basis(points: int, extent: float) -> tuple:
    """(V (M, 3), pinv(V) (3, M)) of the least-squares quadratic
    a + bθ + cθ² over the line offsets θ_j: the trend removed (and
    differentiated analytically: ∂ = b, ∂² = 2c) before the rfft."""
    c = points // 2
    theta = (np.arange(points) - c) * (extent / points)
    V = np.stack([np.ones(points), theta, theta * theta], axis=1)
    return (V.astype(np.float32),
            np.linalg.pinv(V).astype(np.float32))


@functools.lru_cache(maxsize=64)
def _constants(points: int, extent: float, plateau: float,
               device: torch.device, dtype: torch.dtype) -> tuple:
    """The per-grid constants on ``device``, made once per grid: the
    detrend basis V and its pseudo-inverse P, the window, and the
    frequencies k and k1 (k with the Nyquist mode zeroed for ∂)."""
    V, P = _detrend_basis(points, extent)
    k = (2.0 * np.pi / extent) * np.arange(points // 2 + 1,
                                           dtype=np.float32)
    k1 = k.copy()
    if points % 2 == 0:
        k1[-1] = 0.0
    return tuple(torch.tensor(a, dtype=dtype, device=device)
                 for a in (V, P, _window_np(points, plateau), k, k1))


def spectral_line_rows(x: torch.Tensor, n_active: int, points: int,
                       extent: float) -> torch.Tensor:
    """Deduped line-grid rows for a batch of anchors.

    x: (B, D) anchor rows (trailing D − n_active coefficient slots are
    never shifted).  Returns (B·(A·(M−1)+1), D): the B anchor rows first,
    then the per-axis line points without the (shared) center index, in
    (anchor, axis, offset) order, the layout ``line_vals_from_rows_vals``
    inverts."""
    B, D = x.shape
    A, M = n_active, points
    c = M // 2
    off = line_offsets(M, extent, x.device).to(x.dtype)
    off_rest = torch.cat([off[:c], off[c + 1:]])                  # (M-1,)
    eye = torch.eye(A, D, dtype=x.dtype, device=x.device)         # (A, D)
    rest = (x[:, None, None, :]
            + eye[None, :, None, :] * off_rest[None, None, :, None])
    return torch.cat([x, rest.reshape(B * A * (M - 1), D)], dim=0)


def line_vals_from_rows_vals(vals: torch.Tensor, n_anchors: int,
                             n_active: int, points: int) -> torch.Tensor:
    """Invert the ``spectral_line_rows`` layout: values over the deduped
    rows (..., B·(A·(M−1)+1)) → full line values (..., B, A, M), the
    shared anchor value put back at the center index of every line."""
    B, A, M = n_anchors, n_active, points
    c = M // 2
    u0 = vals[..., :B]
    rest = vals[..., B:].reshape(vals.shape[:-1] + (B, A, M - 1))
    center = u0[..., :, None, None].expand(rest.shape[:-1] + (1,))
    return torch.cat([rest[..., :c], center, rest[..., c:]], dim=-1)


def spectral_derivs(line_vals: torch.Tensor, extent: float,
                    periodization="window",
                    plateau: float = 0.25) -> tuple:
    """(∂u, ∂²u) at the anchor (center index) of each line.

    line_vals: (..., M) u-samples along lines (any leading axes: batch,
    axis, the SPSA stack).  ``"periodic"`` differentiates the raw samples;
    ``"window"`` removes the least-squares quadratic trend (differentiated
    analytically) and tapers the residue first.

    ``periodization`` may be a per-axis tuple, e.g. ns-2d's ("periodic",
    "periodic", "window").  A mixed tuple needs the lines' axis dimension
    at position −2 (the (..., B, A, M) layout of
    ``line_vals_from_rows_vals``): entry ``a`` periodizes the lines of
    active axis ``a``.  A uniform tuple is its scalar form."""
    if not isinstance(periodization, str):
        ps = tuple(periodization)
        if not ps:
            raise ValueError("empty periodization tuple")
        if all(p == ps[0] for p in ps):
            return spectral_derivs(line_vals, extent, ps[0], plateau)
        if line_vals.ndim < 2 or line_vals.shape[-2] != len(ps):
            raise ValueError(
                f"per-axis periodization of {len(ps)} entries needs lines "
                f"shaped (..., {len(ps)}, M); got {tuple(line_vals.shape)}")
        per_axis = [spectral_derivs(line_vals[..., a, :], extent, p, plateau)
                    for a, p in enumerate(ps)]
        return (torch.stack([d1 for d1, _ in per_axis], dim=-1),
                torch.stack([d2 for _, d2 in per_axis], dim=-1))
    if periodization not in ("window", "periodic"):
        raise ValueError(f"unknown periodization {periodization!r}; "
                         "expected 'window' or 'periodic'")
    M = line_vals.shape[-1]
    c = M // 2
    V, P, w, k, k1 = _constants(M, float(extent), float(plateau),
                                line_vals.device, line_vals.dtype)
    trend1 = trend2 = None
    v = line_vals
    if periodization == "window":
        coef = line_vals @ P.T                                  # (..., 3)
        trend1, trend2 = coef[..., 1], 2.0 * coef[..., 2]
        v = (line_vals - coef @ V.T) * w
    F = torch.fft.rfft(v, dim=-1)
    d1 = torch.fft.irfft(F * (1j * k1), n=M, dim=-1)[..., c]
    d2 = torch.fft.irfft(F * -(k * k), n=M, dim=-1)[..., c]
    if trend1 is not None:
        d1 = d1 + trend1
        d2 = d2 + trend2
    return d1.to(line_vals.dtype), d2.to(line_vals.dtype)


def spectral_derivs_ref(line_vals, extent: float,
                        periodization="window",
                        plateau: float = 0.25) -> tuple:
    """Naive O(M²) DFT oracle for ``spectral_derivs`` (numpy float64,
    per-mode cos/sin sums, explicit lstsq detrend): the reference's own,
    as it is.  Per-axis periodization tuples loop the axes at position −2,
    as ``spectral_derivs`` does.  ``line_vals`` on the CPU."""
    if not isinstance(periodization, str):
        ps = tuple(periodization)
        v = np.asarray(line_vals, dtype=np.float64)
        if all(p == ps[0] for p in ps):
            return spectral_derivs_ref(line_vals, extent, ps[0], plateau)
        if v.ndim < 2 or v.shape[-2] != len(ps):
            raise ValueError(
                f"per-axis periodization of {len(ps)} entries needs lines "
                f"shaped (..., {len(ps)}, M); got {v.shape}")
        per_axis = [spectral_derivs_ref(v[..., a, :], extent, p, plateau)
                    for a, p in enumerate(ps)]
        return (np.stack([d1 for d1, _ in per_axis], axis=-1),
                np.stack([d2 for _, d2 in per_axis], axis=-1))
    v = np.asarray(line_vals, dtype=np.float64)
    M = v.shape[-1]
    c = M // 2
    d1 = np.zeros(v.shape[:-1])
    d2 = np.zeros(v.shape[:-1])
    if periodization == "window":
        theta = (np.arange(M) - c) * (extent / M)
        V = np.stack([np.ones(M), theta, theta * theta], axis=1)
        coef = v @ np.linalg.pinv(V).T
        v = (v - coef @ V.T) * _window_np(M, plateau).astype(np.float64)
        d1 += coef[..., 1]
        d2 += 2.0 * coef[..., 2]
    elif periodization != "periodic":
        raise ValueError(periodization)
    j = np.arange(M)
    for m in range(M // 2 + 1):
        km = 2.0 * np.pi * m / extent
        scale = (1.0 if m in (0, M - m) else 2.0) / M
        cm = np.sum(v * np.cos(2 * np.pi * m * j / M), axis=-1) * scale
        sm = np.sum(v * np.sin(2 * np.pi * m * j / M), axis=-1) * scale
        cos_c = np.cos(2 * np.pi * m * c / M)
        sin_c = np.sin(2 * np.pi * m * c / M)
        if not (M % 2 == 0 and m == M // 2):   # Nyquist odd derivative → 0
            d1 += km * (-cm * sin_c + sm * cos_c)
        d2 += -km * km * (cm * cos_c + sm * sin_c)
    return d1, d2


def estimate_from_line_vals(vals: torch.Tensor, anchors: torch.Tensor,
                            n_active: int, points: int, extent: float,
                            periodization="window",
                            carrier=None) -> stein.DerivativeEstimate:
    """A ``DerivativeEstimate`` from u-values over the deduped line rows:
    the entry point the PINN loss paths share with ``spectral_estimate``
    (they evaluate u themselves, through the stacked forward).

    vals: (..., R) values over ``spectral_line_rows(anchors, ...)`` (any
    leading axes: the SPSA stack P).  ``carrier`` is None, a
    ``(β(rows), ∇β(anchors), diag∇²β(anchors))`` triple, or a callable
    ``rows, anchors -> triple | None`` (``PDEProblem.spectral_carrier``;
    None means no closed-form part).  Leaves are (..., B, A), u the true u
    at the anchors (carrier included)."""
    B = anchors.shape[0]
    u0 = vals[..., :B]
    if callable(carrier):
        rows = spectral_line_rows(anchors, n_active, points, extent)
        carrier = carrier(rows, anchors)
    if carrier is not None:
        beta, bgrad, bhess = carrier
        vals = vals - beta
    lines = line_vals_from_rows_vals(vals, B, n_active, points)
    grad, hess = spectral_derivs(lines, extent, periodization)
    if carrier is not None:
        grad = grad + bgrad
        hess = hess + bhess
    return stein.DerivativeEstimate(u=u0, grad=grad, hess_diag=hess)


def spectral_estimate(f: Callable[[torch.Tensor], torch.Tensor],
                      x: torch.Tensor, points: int = 32, extent: float = 1.0,
                      periodization="window", n_active: int | None = None,
                      carrier=None) -> stein.DerivativeEstimate:
    """Spectral derivatives of ``f`` at the anchors ``x`` (B, D) through one
    batched forward over the per-axis line grids.  ``n_active`` restricts
    the differentiated coordinates to the first A columns (A = D when
    None); ``carrier`` as in ``estimate_from_line_vals``.  Leaves are
    (B, A)."""
    A = x.shape[1] if n_active is None else n_active
    rows = spectral_line_rows(x, A, points, extent)
    if callable(carrier):
        carrier = carrier(rows, x)
    return estimate_from_line_vals(f(rows), x, A, points, extent,
                                   periodization, carrier)
