"""The port's attention (``kernels.ops.attention``, on the CPU its plain
version ``kernels.ref.attention_ref``) against the JAX package's
``flash_attention`` Pallas kernel in interpret mode and its
``attention_ref``, from the same numpy inputs.

Tolerances: f32 ``rtol = atol = 2e-5`` (the same products and exponentials
summed in another order), bf16 ``3e-2`` (one bf16 ulp at |x| ≈ 4 is 0.03;
the two round f32 results that differ in the last bits), both as
``tests/test_kernels.py`` holds the Pallas kernel to ``attention_ref``.
Where a row sees no key the port follows the kernel (zeros), not JAX's
``attention_ref`` (NaN from a softmax over −inf).  The Pallas kernel's bf16
output also stays within ``ref.attention_bound``, the elementwise bound the
CUDA kernel is held to on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref

# (B, H, KH, Sq, Sk, D, causal, window): tests/test_kernels.py's FA_CASES,
# then causal rows that see no key (Sq > Sk) and a window that empties rows
FA_CASES = [
    (1, 4, 4, 128, 128, 64, True, None),     # MHA causal
    (2, 8, 2, 256, 256, 64, True, None),     # GQA
    (1, 8, 8, 200, 200, 32, True, None),     # unaligned seq
    (2, 4, 2, 256, 256, 64, True, 100),      # sliding window
    (1, 4, 2, 32, 256, 64, True, None),      # chunked prefill (Sq < Sk)
    (1, 4, 1, 1, 300, 64, True, None),       # single-query decode
    (1, 4, 4, 128, 128, 64, False, None),    # bidirectional (encoder)
    (1, 2, 2, 64, 32, 32, True, None),       # rows 0..31 see no key
]
FULLY_MASKED = {(1, 2, 2, 64, 32, 32, True, None)}
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(B, H, KH, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D), dtype=np.float32),
            rng.standard_normal((B, KH, Sk, D), dtype=np.float32),
            rng.standard_normal((B, KH, Sk, D), dtype=np.float32))


def _both(arrays, dtype):
    """The same values as JAX arrays and torch tensors of ``dtype`` (bf16
    rounded once, by JAX, and handed over bit for bit)."""
    _, jdt, tdt, _ = DTYPES[dtype]
    jx = [jnp.asarray(a).astype(jdt) for a in arrays]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
          for a in jx]
    return jx, tx


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_attention_matches_the_pallas_kernel(case, dtype):
    B, H, KH, Sq, Sk, D, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, H, KH, Sq, Sk, D), dtype)
    want = jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                               interpret=True)
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == DTYPES[dtype][2] and got.shape == (B, H, Sq, D)
    tol = DTYPES[dtype][3]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_attention_matches_jax_attention_ref(case):
    B, H, KH, Sq, Sk, D, causal, window = case
    arrays = _inputs(B, H, KH, Sq, Sk, D, seed=1)
    want = np.asarray(jref.attention_ref(*map(jnp.asarray, arrays),
                                         causal=causal, window=window))
    got = _np(ref.attention_ref(*map(torch.from_numpy, arrays),
                                causal=causal, window=window))
    if case in FULLY_MASKED:
        dead = Sq - Sk                          # JAX's ref: NaN there
        assert np.isnan(want[:, :, :dead]).all()
        assert (got[:, :, :dead] == 0).all()
        got, want = got[:, :, dead:], want[:, :, dead:]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_a_window_that_empties_rows_gives_zeros():
    """window 0 masks every key (``k > q_abs``) against causal's
    ``k ≤ q_abs``: every row is zeros in the kernel and the port."""
    arrays = _inputs(1, 2, 1, 16, 16, 8, seed=2)
    want = np.asarray(jfa.flash_attention(*map(jnp.asarray, arrays),
                                          window=0, interpret=True))
    got = _np(ops.attention(*map(torch.from_numpy, arrays), window=0))
    assert (want == 0).all() and (got == 0).all()


def test_scale_and_block_boundaries():
    """An explicit ``scale`` and lengths off the 64-wide tiles of the CUDA
    kernel, against the Pallas kernel."""
    arrays = _inputs(1, 4, 2, 65, 130, 24, seed=3)
    want = jfa.flash_attention(*map(jnp.asarray, arrays), window=70,
                               scale=0.3, interpret=True)
    got = ops.attention(*map(torch.from_numpy, arrays), window=70, scale=0.3)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_plain_version_takes_strided_views():
    """``attention_fwd`` hands over transposed views; the plain version
    reads them as they are."""
    q, k, v = map(torch.from_numpy, _inputs(2, 4, 2, 40, 40, 16, seed=4))
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qt.is_contiguous()
    torch.testing.assert_close(ref.attention_ref(qt, k, v),
                               ref.attention_ref(q, k, v))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = tfa.flash_attention.launches
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 1, 8, 8, 8, seed=5))
    torch.testing.assert_close(ops.attention(q, k, v),
                               ref.attention_ref(q, k, v))
    assert tfa.flash_attention.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 1, 8, 8, 8, seed=6))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention(q, k, v)


def test_plain_version_refuses_mismatched_heads():
    q, k, v = map(torch.from_numpy, _inputs(1, 3, 2, 8, 8, 8, seed=7))
    with pytest.raises(ValueError, match="multiple"):
        ref.attention_ref(q, k, v)


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_pallas_kernel_in_bf16_within_attention_bound(case):
    """``ref.attention_bound``, the bound the CUDA kernel is held to on the
    card, holds for another streaming kernel: the Pallas one, whose f32
    sums run in another order than the plain version's."""
    B, H, KH, Sq, Sk, D, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, H, KH, Sq, Sk, D, seed=8),
                                       "bfloat16")
    want = np.asarray(jfa.flash_attention(jq, jk, jv, causal=causal,
                                          window=window, interpret=True),
                      np.float32)
    plain = ref.attention_ref(tq, tk, tv, causal=causal, window=window)
    err = np.abs(want - _np(plain))
    assert (err <= ref.attention_bound(plain).numpy()).all(), err.max()


def test_bf16_bound_is_each_elements_ulp():
    """In bf16 the bound is one ulp of each element's own |plain|.  Output
    that differs from the plain version only in f32 rounding before the
    bf16 cast passes.  Drop one 64-key tile from the last row of a
    2048-key causal row (outputs ~0.03 there): the bound flags nine in ten
    of its elements, where one ulp of max|plain| flags under one in
    twenty."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(1, 2, 1, 2048, 2048, 128, seed=9))
    plain = ref.attention_ref(q, k, v)
    bound = ref.attention_bound(plain)
    f32 = ref.attention_ref(q.float(), k.float(), v.float())
    noise = torch.randn(f32.shape, generator=torch.Generator().manual_seed(0))
    jittered = (f32 * (1 + 1e-6 * noise)).to(torch.bfloat16)
    assert ((jittered.float() - plain.float()).abs() <= bound).all()
    keep = torch.ones(2048, dtype=torch.bool)
    keep[640:704] = False
    # the last row sees every key, so it is bidirectional over what is kept
    dropped = ref.attention_ref(q[:, :, -1:], k[:, :, keep], v[:, :, keep],
                                causal=False)
    err = (dropped.float() - plain[:, :, -1:].float()).abs()
    assert (err > bound[:, :, -1:]).float().mean() > 0.9
    global_ulp = 2.0 ** (math.floor(math.log2(plain.abs().max().item())) - 7)
    assert (err > global_ulp).float().mean() < 0.05


# ------------------------------------------- the bf16 kernel's numeric design

# (B, H, KH, S, D, causal, window): a causal prefill, a window off the tiles
# at h2o-danube's head dim, bidirectional frames
SPLIT_CASES = {
    "causal": (1, 2, 1, 512, 128, True, None),
    "window": (1, 2, 1, 333, 120, True, 70),
    "bidirectional": (1, 2, 1, 300, 64, False, None),
}


def _emulate_kernel(q, k, v, causal, window, split=True):
    """The bf16 kernel's arithmetic in plain torch: 64-key tiles, scores in
    f32 scaled into log2 units, running max and sum (``l`` from the f32
    p), P·V as ``bf16(p) + bf16(p − bf16(p))`` against V (two exact
    products summed in f32; ``split=False`` keeps only ``bf16(p)``, the
    usual tensor-core design), each tile's product added to O in f32, and
    the output rounded to bf16."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KH, (H // KH) * Sq, D)
    kf, vf = k.float(), v.float()
    c = (1.0 / math.sqrt(D)) * math.log2(math.e)
    q_abs = (torch.arange(Sq) + Sk - Sq).repeat(H // KH)[:, None]
    m = torch.full((B, KH, qf.shape[2], 1), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    for k0 in range(0, Sk, 64):
        keys = torch.arange(k0, min(k0 + 64, Sk))[None, :]
        seen = torch.ones(q_abs.shape[0], keys.shape[1], dtype=torch.bool)
        if causal:
            seen &= keys <= q_abs
        if window is not None:
            seen &= keys > q_abs - window
        s = torch.matmul(qf, kf[:, :, k0:k0 + 64].transpose(-1, -2)) * c
        s = s.masked_fill(~seen, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new).masked_fill(~seen, 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        t = torch.matmul(hi, vf[:, :, k0:k0 + 64])
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            t = t + torch.matmul(lo, vf[:, :, k0:k0 + 64])
        o = o * alpha + t
        m = m_new
    out = torch.where(l == 0, 0.0, o / torch.where(l == 0, 1.0, l))
    return out.reshape(B, H, Sq, D).to(torch.bfloat16)


def _split_share(label, seed, split):
    B, H, KH, S, D, causal, window = SPLIT_CASES[label]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(B, H, KH, S, S, D, seed=seed))
    plain = ref.attention_ref(q, k, v, causal, window)
    got = _emulate_kernel(q, k, v, causal, window, split)
    err = (got.float() - plain.float()).abs()
    return (err / ref.attention_bound(plain)).max().item()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("label", sorted(SPLIT_CASES))
def test_split_p_design_stays_within_attention_bound(label, seed):
    """P split into two bf16 halves keeps the bf16 kernel's output within
    ``ref.attention_bound`` of the plain version at every element."""
    assert _split_share(label, seed, split=True) <= 1.0


@pytest.mark.parametrize("label", sorted(SPLIT_CASES))
def test_bf16_p_alone_exceeds_attention_bound(label):
    """Why P is split: rounded to bf16 alone, as fast tensor-core
    attention kernels round it, P·V leaves the bound many times over."""
    assert _split_share(label, 0, split=False) > 5.0


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_tensor_map_of_a_contiguous_tensor():
    assert tfa.tensor_map(_bf16((2, 8, 300, 128))) == (
        128, 300, 8, 2, 256, 256 * 300, 256 * 300 * 8, 1, 2, 3)


def test_tensor_map_takes_attention_fwds_transposed_views():
    """(B, S, H, D) transposed to (B, H, S, D): the map orders the axes by
    stride (heads, then rows, then batch) and reads the view in place."""
    v = _bf16((2, 300, 8, 128)).transpose(1, 2)
    assert not v.is_contiguous()
    assert tfa.tensor_map(v) == (128, 8, 300, 2, 256, 2048, 2048 * 300,
                                 2, 1, 3)


def test_tensor_map_takes_a_sliced_head_dim_and_puts_unit_axes_last():
    t = _bf16((1, 4, 1, 136))[..., :128]
    assert tfa.tensor_map(t) == (128, 4, 1, 1, 272, 1088, 1088, 2, 1, 3)


@pytest.mark.parametrize("view", [
    "stride-not-16-bytes", "last-dim-strided", "misaligned-base",
    "expanded-axis"])
def test_tensor_map_refuses_views_that_need_a_copy(view):
    t = {"stride-not-16-bytes": lambda: _bf16((1, 2, 8, 12))[..., :8],
         "last-dim-strided": lambda: _bf16((1, 2, 8, 16))[..., ::2],
         "misaligned-base": lambda: _bf16((145,))[1:].view(1, 2, 9, 8),
         "expanded-axis": lambda: _bf16((1, 1, 8, 16)).expand(2, 3, 8, 16),
         }[view]()
    assert tfa.tensor_map(t) is None
    # the wrapper's copy: contiguous, in fresh memory
    assert tfa.tensor_map(t.clone(memory_format=torch.contiguous_format))


def test_tensor_map_raises_on_a_head_dim_off_16_bytes():
    with pytest.raises(ValueError, match="16 bytes"):
        tfa.tensor_map(_bf16((1, 2, 8, 20)))
