"""Tensor-train (TT) decomposition and contraction — the paper's §2.1.

A weight matrix ``W ∈ R^{M×N}`` with ``M = Π m_k``, ``N = Π n_k`` is held as
TT-cores ``G_k ∈ R^{r_{k-1} × m_k × n_k × r_k}`` (``r_0 = r_L = 1``).  A TT
"linear layer" computes ``y = x W^T`` with ``x: (..., N)`` → ``y: (..., M)``.

``tt_svd`` decomposes a dense matrix into cores (TT-SVD, in float64 on the
host, as the reference does).  Port of ``repro.core.tt``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

__all__ = ["TTSpec", "auto_factorize", "hjb_layer_spec", "PAPER_TONN_SPEC",
           "tt_init", "tt_matvec", "tt_matvec_stacked", "tt_to_full",
           "tt_svd", "tt_num_params"]


@dataclasses.dataclass(frozen=True)
class TTSpec:
    """Static shape description of one TT-factorized (out_dim × in_dim) matrix."""

    out_modes: tuple  # (m_1, ..., m_L)
    in_modes: tuple   # (n_1, ..., n_L)
    ranks: tuple      # (r_0, r_1, ..., r_L) with r_0 = r_L = 1

    def __post_init__(self):
        if len(self.out_modes) != len(self.in_modes):
            raise ValueError("out_modes and in_modes must have equal length")
        if len(self.ranks) != len(self.out_modes) + 1:
            raise ValueError("ranks must have length L+1")
        if self.ranks[0] != 1 or self.ranks[-1] != 1:
            raise ValueError("TT boundary ranks must be 1")

    @property
    def L(self) -> int:
        return len(self.out_modes)

    @property
    def out_dim(self) -> int:
        return math.prod(self.out_modes)

    @property
    def in_dim(self) -> int:
        return math.prod(self.in_modes)

    @property
    def core_shapes(self) -> tuple:
        return tuple(
            (self.ranks[k], self.out_modes[k], self.in_modes[k], self.ranks[k + 1])
            for k in range(self.L)
        )

    @property
    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.core_shapes)

    def contraction_flops(self, batch: int) -> int:
        """Floating-point operations (2 per multiply-add) of the chain for
        a flattened batch of ``batch`` rows."""
        flops = 0
        m_prefix = 1
        n_suffix = self.in_dim
        for k in range(self.L):
            n_suffix //= self.in_modes[k]
            flops += (batch * m_prefix * n_suffix
                      * (self.ranks[k] * self.in_modes[k])
                      * (self.out_modes[k] * self.ranks[k + 1]))
            m_prefix *= self.out_modes[k]
        return 2 * flops


def _balanced_factorization(n: int, parts: int) -> list:
    """Factor ``n`` into ``parts`` integer factors, as balanced as possible
    (largest primes first into the currently smallest bin)."""
    primes = []
    x = n
    d = 2
    while d * d <= x:
        while x % d == 0:
            primes.append(d)
            x //= d
        d += 1
    if x > 1:
        primes.append(x)
    if len(primes) < parts:
        primes += [1] * (parts - len(primes))
    primes.sort(reverse=True)
    bins = [1] * parts
    for p in primes:
        bins[int(np.argmin(bins))] *= p
    bins.sort(reverse=True)
    return bins


def auto_factorize(out_dim: int, in_dim: int, L: int = 4, max_rank: int = 16) -> TTSpec:
    """TTSpec for an arbitrary (out_dim × in_dim) Linear: balanced mode
    factorizations and a constant internal rank capped by ``max_rank``
    and by the full unfolding rank."""
    out_modes = tuple(_balanced_factorization(out_dim, L))
    in_modes = tuple(_balanced_factorization(in_dim, L))
    ranks = [1]
    for k in range(1, L):
        left = math.prod(out_modes[i] * in_modes[i] for i in range(k))
        right = math.prod(out_modes[i] * in_modes[i] for i in range(k, L))
        ranks.append(min(max_rank, left, right))
    ranks.append(1)
    return TTSpec(out_modes=out_modes, in_modes=in_modes, ranks=tuple(ranks))


#: The paper's §4.2 factorization: 1024×1024 = [4,8,4,8]·[8,4,8,4],
#: TT-ranks [1,2,1,2,1] → 256 parameters per layer.
PAPER_TONN_SPEC = TTSpec(out_modes=(4, 8, 4, 8), in_modes=(8, 4, 8, 4),
                         ranks=(1, 2, 1, 2, 1))


def hjb_layer_spec(out_dim: int, in_dim: int, L: int = 4,
                   max_rank: int = 2) -> TTSpec:
    """TT spec for a PINN layer: the paper's exact factorization for the
    1024×1024 case, balanced auto-factorization otherwise."""
    if out_dim == in_dim == 1024 and L == 4 and max_rank == 2:
        return PAPER_TONN_SPEC
    return auto_factorize(out_dim, in_dim, L=L, max_rank=max_rank)


def tt_init(generator: torch.Generator, spec: TTSpec,
            scale: float | None = None) -> list:
    """TT-cores whose implied dense W has ~Glorot variance.

    Drawn on the CPU from ``generator`` (so the weights of a seed do not
    depend on the device); the caller moves them.
    """
    target_var = scale if scale is not None else 2.0 / (spec.in_dim + spec.out_dim)
    n_paths = float(math.prod(spec.ranks[1:-1])) if spec.L > 1 else 1.0
    per_core_std = math.sqrt((target_var / n_paths) ** (1.0 / spec.L))
    return [torch.randn(shape, generator=generator, dtype=torch.float32)
            * per_core_std for shape in spec.core_shapes]


def tt_matvec(cores: Sequence[torch.Tensor], x: torch.Tensor,
              spec: TTSpec) -> torch.Tensor:
    """``y = x @ W(cores)^T`` without materializing ``W``.

    x: (..., N) → y: (..., M).  Invariant over the chain:
    ``A_k: (B, m_1..m_k, r_k, n_{k+1}..n_L)``; each step contracts
    ``(r_{k-1}, n_k)`` with ``G_k`` as a (B·M_<k, N_>k, r·n_k) @
    (r·n_k, m_k·r') matmul.
    """
    batch_shape = x.shape[:-1]
    B = math.prod(batch_shape)
    n_suffix = spec.in_dim
    m_prefix = 1
    a = x.reshape(B, spec.in_dim)
    for k in range(spec.L):
        r, m_k, n_k, r_next = spec.core_shapes[k]
        n_suffix //= n_k
        a = a.reshape(B * m_prefix, r * n_k, n_suffix).transpose(1, 2)
        g = cores[k].permute(0, 2, 1, 3).reshape(r * n_k, m_k * r_next)
        a = torch.matmul(a, g)                     # (B·M_<k, N_>k, m_k·r')
        a = a.reshape(B * m_prefix, n_suffix, m_k, r_next).permute(0, 2, 3, 1)
        m_prefix *= m_k
    return a.reshape(*batch_shape, spec.out_dim)


def tt_matvec_stacked(cores: Sequence[torch.Tensor], x: torch.Tensor,
                      spec: TTSpec) -> torch.Tensor:
    """``tt_matvec`` over a leading stack axis P on the cores (the plain
    version of ``kernels.tt_contract.tt_contract_batched``).

    cores: each ``(P, r, m, n, r')``.  x: ``(B, N)`` shared across the
    stack or ``(P, B, N)`` per entry.  Returns ``(P, B, M)``.  Each entry
    runs the chain of ``tt_matvec``, the shared x broadcast (never copied
    P times) against the stacked cores.
    """
    P = cores[0].shape[0]
    a = x.reshape(-1, x.shape[-2], spec.in_dim)        # (1 or P, B, N)
    B = a.shape[1]
    n_suffix = spec.in_dim
    m_prefix = 1
    for k in range(spec.L):
        r, m_k, n_k, r_next = spec.core_shapes[k]
        n_suffix //= n_k
        a = a.reshape(a.shape[0], B * m_prefix, r * n_k,
                      n_suffix).transpose(2, 3)
        g = cores[k].permute(0, 1, 3, 2, 4).reshape(P, 1, r * n_k,
                                                    m_k * r_next)
        a = torch.matmul(a, g)                     # (P, B·M_<k, N_>k, m_k·r')
        a = a.reshape(P, B * m_prefix, n_suffix, m_k,
                      r_next).permute(0, 1, 3, 4, 2)
        m_prefix *= m_k
    return a.reshape(P, B, spec.out_dim)


def tt_to_full(cores: Sequence[torch.Tensor], spec: TTSpec) -> torch.Tensor:
    """Densify TT-cores into the full (out_dim, in_dim) matrix (oracle)."""
    t = cores[0].reshape(spec.out_modes[0], spec.in_modes[0], spec.ranks[1])
    for k in range(1, spec.L):
        t = torch.tensordot(t, cores[k], dims=([-1], [0]))
    t = t.reshape([d for k in range(spec.L)
                   for d in (spec.out_modes[k], spec.in_modes[k])])
    perm = list(range(0, 2 * spec.L, 2)) + list(range(1, 2 * spec.L, 2))
    return t.permute(perm).reshape(spec.out_dim, spec.in_dim)


def tt_svd(w, spec: TTSpec, device=None) -> list:
    """TT-SVD (Oseledets 2011): decompose a dense (M, N) matrix (array or
    tensor) into TT-cores with the ranks given by ``spec``, a truncated SVD
    at each unfolding, in numpy float64 as the reference does; ranks the
    data lacks are zero-padded up to the spec.  Returns float32 cores on
    the CPU, or on ``device``."""
    w = (w.detach().cpu().numpy() if isinstance(w, torch.Tensor)
         else np.asarray(w))
    M, N = w.shape
    if M != spec.out_dim or N != spec.in_dim:
        raise ValueError(f"shape mismatch: {w.shape} vs spec "
                         f"{spec.out_dim}x{spec.in_dim}")
    L = spec.L
    # (m1, ..., mL, n1, ..., nL) interleaved to (m1, n1, m2, n2, ...)
    t = w.astype(np.float64).reshape(tuple(spec.out_modes)
                                     + tuple(spec.in_modes))
    t = np.transpose(t, [d for k in range(L) for d in (k, L + k)])
    cores = []
    r_prev = 1
    for k in range(L - 1):
        m_k, n_k = spec.out_modes[k], spec.in_modes[k]
        t = t.reshape(r_prev * m_k * n_k, -1)
        u, s, vt = np.linalg.svd(t, full_matrices=False)
        r_k = min(spec.ranks[k + 1], s.shape[0])
        u, s, vt = u[:, :r_k], s[:r_k], vt[:r_k]
        cores.append(u.reshape(r_prev, m_k, n_k, r_k))
        t = s[:, None] * vt
        r_prev = r_k
    cores.append(t.reshape(r_prev, spec.out_modes[-1], spec.in_modes[-1], 1))
    out = []
    for c, shape in zip(cores, spec.core_shapes):
        c = np.pad(c, [(0, want - have) for want, have in zip(shape, c.shape)])
        out.append(torch.tensor(c, dtype=torch.float32, device=device))
    return out


def tt_num_params(spec: TTSpec) -> int:
    """Parameters of the spec's cores."""
    return spec.num_params
