"""The port's TT algebra and its ``tt_linear`` dispatch against the JAX package.

Every input is made with numpy from a seed and handed to both packages.
Tolerance for outputs: ``rtol=1e-5, atol=1e-5`` — the two sides take the
same f32 products but sum them in a different order over the chain steps.
The JAX side runs ``ops.tt_linear`` both through its plain chain
(``mode="ref"``) and through the Pallas kernel body in interpret mode, as
``tests/test_kernels.py`` runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import tt as jtt
from repro.kernels import ops as jops
from repro_torch.core import tt as ttt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tt_contract as tttc

RTOL = ATOL = 1e-5

# (out_dim, in_dim, L, max_rank)
FACTOR_CASES = [(1024, 1024, 4, 2), (64, 64, 3, 2), (256, 512, 3, 4),
                (128, 96, 3, 4), (48, 60, 3, 16), (1024, 24, 4, 2),
                (7, 13, 2, 3)]

# label -> (spec, batch shape); 3-4 auto_factorize specs besides the paper's
CHAIN_CASES = {
    "paper": (jtt.PAPER_TONN_SPEC, (33,)),
    "reduced-64": (jtt.auto_factorize(64, 64, L=3, max_rank=2), (17,)),
    "rank4-256x512": (jtt.auto_factorize(256, 512, L=3, max_rank=4), (9,)),
    "nonsquare-96x128": (jtt.auto_factorize(96, 128, L=2, max_rank=8), (5,)),
    "paper-batch-axes": (jtt.PAPER_TONN_SPEC, (3, 5)),
    "reduced-batch-axes": (jtt.auto_factorize(64, 64, L=3, max_rank=2),
                           (2, 3, 4)),
}


def _port_spec(spec: jtt.TTSpec) -> ttt.TTSpec:
    return ttt.TTSpec(spec.out_modes, spec.in_modes, spec.ranks)


def _inputs(spec, batch_shape, seed):
    rng = np.random.RandomState(seed)
    cores = [rng.standard_normal(s).astype(np.float32) * 0.5
             for s in spec.core_shapes]
    x = rng.standard_normal((*batch_shape, spec.in_dim)).astype(np.float32)
    return cores, x


@pytest.mark.parametrize("out_dim,in_dim,L,rank", FACTOR_CASES)
def test_specs_equal_jax(out_dim, in_dim, L, rank):
    for make in ("auto_factorize", "hjb_layer_spec"):
        js = getattr(jtt, make)(out_dim, in_dim, L=L, max_rank=rank)
        ps = getattr(ttt, make)(out_dim, in_dim, L=L, max_rank=rank)
        assert (ps.out_modes, ps.in_modes, ps.ranks) == \
            (js.out_modes, js.in_modes, js.ranks)
        assert ps.core_shapes == js.core_shapes
        assert ps.num_params == js.num_params
        assert (ps.in_dim, ps.out_dim, ps.L) == (js.in_dim, js.out_dim, js.L)
        for batch in (1, 2048):
            assert ps.contraction_flops(batch) == js.contraction_flops(batch)


def test_paper_spec_and_balanced_factorization():
    assert ttt.PAPER_TONN_SPEC == _port_spec(jtt.PAPER_TONN_SPEC)
    assert ttt.PAPER_TONN_SPEC.num_params == 256
    for n in (1, 7, 24, 1000, 1024, 4096):
        for parts in (1, 2, 3, 4):
            assert ttt._balanced_factorization(n, parts) == \
                jtt._balanced_factorization(n, parts)
    with pytest.raises(ValueError):
        ttt.TTSpec((2, 2), (2, 2), (1, 3, 2))


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("label", sorted(CHAIN_CASES))
def test_tt_linear_matches_jax(label, mode):
    spec, batch_shape = CHAIN_CASES[label]
    cores, x = _inputs(spec, batch_shape, seed=len(label))
    y_jax = np.asarray(jops.tt_linear(jnp.asarray(x),
                                      [jnp.asarray(c) for c in cores],
                                      spec, mode=mode))
    y = tops.tt_linear(torch.tensor(x), [torch.tensor(c) for c in cores],
                       _port_spec(spec))
    assert tuple(y.shape) == (*batch_shape, spec.out_dim)
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("label", ["paper", "reduced-64", "rank4-256x512"])
def test_tt_to_full_matches_jax_and_chain(label):
    spec, _ = CHAIN_CASES[label]
    cores, x = _inputs(spec, (6,), seed=3)
    w_jax = np.asarray(jtt.tt_to_full([jnp.asarray(c) for c in cores], spec))
    tcores = [torch.tensor(c) for c in cores]
    w = ttt.tt_to_full(tcores, _port_spec(spec))
    np.testing.assert_allclose(w.numpy(), w_jax, rtol=RTOL, atol=ATOL)
    # the chain equals the dense product it never forms
    np.testing.assert_allclose(
        ttt.tt_matvec(tcores, torch.tensor(x), _port_spec(spec)).numpy(),
        (x.astype(np.float64) @ w_jax.T.astype(np.float64)),
        rtol=RTOL, atol=ATOL)


def test_tt_init_is_seeded_and_glorot_scaled():
    spec = ttt.PAPER_TONN_SPEC
    a = ttt.tt_init(torch.Generator().manual_seed(5), spec)
    b = ttt.tt_init(torch.Generator().manual_seed(5), spec)
    assert [tuple(c.shape) for c in a] == list(spec.core_shapes)
    assert all(c.dtype == torch.float32 for c in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # implied dense W has about the Glorot variance 2 / (in + out)
    w = torch.cat([ttt.tt_to_full(ttt.tt_init(
        torch.Generator().manual_seed(s), spec), spec).flatten()
        for s in range(4)])
    assert 0.5 < float(w.var()) * (spec.in_dim + spec.out_dim) / 2.0 < 2.0


def test_plain_version_is_the_chain():
    spec = _port_spec(CHAIN_CASES["rank4-256x512"][0])
    cores, x = _inputs(spec, (4,), seed=9)
    tcores = [torch.tensor(c) for c in cores]
    assert torch.equal(tref.tt_contract_ref(torch.tensor(x), tcores, spec),
                       ttt.tt_matvec(tcores, torch.tensor(x), spec))


def test_cpu_dispatch_never_launches_the_kernel():
    spec = ttt.PAPER_TONN_SPEC
    cores, x = _inputs(spec, (4,), seed=1)
    before = tttc.tt_contract.launches
    tops.tt_linear(torch.tensor(x), [torch.tensor(c) for c in cores], spec)
    assert tttc.tt_contract.launches == before


def test_kernel_wrapper_refuses_what_it_cannot_take():
    """The wrapper runs CUDA tensors only; everything else raises before
    any build or launch — on the CPU and on a device without storage."""
    spec = ttt.PAPER_TONN_SPEC
    cores = [torch.zeros(s) for s in spec.core_shapes]
    with pytest.raises(ValueError, match="CUDA"):
        tttc.tt_contract(torch.zeros(2, 1024), cores, spec)
    # the dispatcher sends any non-CPU tensor to the kernel, never to the
    # plain version: a meta tensor reaches the wrapper and is refused
    meta_cores = [c.to("meta") for c in cores]
    with pytest.raises(ValueError, match="CUDA"):
        tops.tt_linear(torch.zeros(2, 1024, device="meta"), meta_cores, spec)


# label -> (P, B): the three launches of a ZO step at the paper's config
# (N = 10, batch 100): layer 0 on the 100 rows and on the 21 identity
# columns, shared x, and the hidden layer's 4300 stencil rows per entry
ZO_STEP_LAUNCHES = {"layer0-rows": (11, 100), "layer0-columns": (11, 21),
                    "hidden-stencil": (11, 4300)}


@pytest.mark.parametrize("label", sorted(ZO_STEP_LAUNCHES))
def test_kernel_tiling_fits_shared_memory(label):
    """The fiber tile ``tt_contract_batched`` launches a ZO step's chains
    with at the paper's spec: one in-place row buffer as wide as the widest
    intermediate, three blocks to an SM, and no more rows a block than put
    three blocks on each SM; the grid's P axis within its extent."""
    spec = ttt.PAPER_TONN_SPEC
    P, B = ZO_STEP_LAUNCHES[label]
    widest = tttc.chain_widest(spec)
    assert widest == 1024              # 4 KB per row at every chain step
    tile = tttc.fiber_tile(spec, P * B)
    assert tile.buffers == 1 and tile.stride == widest
    assert tile.smem_bytes == 4 * (tttc._core_floats(spec)
                                   + sum(c * c for c in tile.caps)
                                   + tile.rows * tile.stride)
    assert tile.smem_bytes <= tttc.SMEM_BLOCK_BUDGET
    fill = -(-P * B // (tttc.BLOCKS_PER_SM * tttc.H100_SMS))
    assert tile.rows == min(fill, tttc.fiber_tile(spec).rows)
    assert {"layer0-rows": 3, "layer0-columns": 1,
            "hidden-stencil": 16}[label] == tile.rows
    assert P <= tttc.MAX_STACK


# --------------------------------------------------- stacked chain (ZO path)

# label -> (spec, P, x shape without its leading P, shared_x); reduced
# widths (hidden 64, L 3), a rank-4 spec and the paper's spec at P 3, B 4
BATCHED_CASES = {
    "reduced-shared": (jtt.auto_factorize(64, 64, L=3, max_rank=2), 4, (8,),
                       True),
    "reduced-per-entry": (jtt.auto_factorize(64, 64, L=3, max_rank=2), 4,
                          (8,), False),
    "rank4-per-entry": (jtt.auto_factorize(32, 48, L=3, max_rank=4), 2,
                        (5,), False),
    "reduced-shared-axes": (jtt.auto_factorize(64, 64, L=3, max_rank=2), 3,
                            (2, 4), True),
    "reduced-per-entry-axes": (jtt.auto_factorize(64, 64, L=3, max_rank=2),
                               3, (2, 3), False),
    "paper-shared": (jtt.PAPER_TONN_SPEC, 3, (4,), True),
    "paper-per-entry": (jtt.PAPER_TONN_SPEC, 3, (4,), False),
}


def _stacked_inputs(spec, P, x_shape, shared, seed):
    """Cores at ``tt_init``'s Glorot scale, so outputs are O(1) and an
    absolute 1e-6 is about 10 f32 ulps of them."""
    rng = np.random.RandomState(seed)
    var = 2.0 / (spec.in_dim + spec.out_dim) / np.prod(spec.ranks[1:-1])
    std = float(var ** (0.5 / spec.L))
    cores = [rng.standard_normal((P, *s)).astype(np.float32) * std
             for s in spec.core_shapes]
    lead = () if shared else (P,)
    x = rng.standard_normal((*lead, *x_shape, spec.in_dim)).astype(np.float32)
    return cores, x


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("label", sorted(BATCHED_CASES))
def test_tt_linear_batched_matches_jax(label, mode):
    """The plain stacked chain against JAX's plain version and against the
    Pallas kernel body in interpret mode: shared x, per-entry x and extra
    batch axes."""
    spec, P, x_shape, shared = BATCHED_CASES[label]
    cores, x = _stacked_inputs(spec, P, x_shape, shared, seed=len(label))
    y_jax = np.asarray(jops.tt_linear_batched(
        jnp.asarray(x), [jnp.asarray(c) for c in cores], spec, mode=mode,
        shared_x=shared))
    y = tops.tt_linear_batched(torch.tensor(x),
                               [torch.tensor(c) for c in cores],
                               _port_spec(spec), shared_x=shared)
    assert tuple(y.shape) == (P, *x_shape, spec.out_dim)
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=RTOL, atol=1e-6)


def test_tt_matvec_stacked_matches_jax_and_the_single_chain():
    spec = CHAIN_CASES["rank4-256x512"][0]
    cores, x = _stacked_inputs(spec, 3, (6,), False, seed=4)
    want = np.asarray(jtt.tt_matvec_stacked([jnp.asarray(c) for c in cores],
                                            jnp.asarray(x), spec))
    tcores = [torch.tensor(c) for c in cores]
    got = ttt.tt_matvec_stacked(tcores, torch.tensor(x), _port_spec(spec))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    for p in range(3):
        np.testing.assert_allclose(
            got[p].numpy(),
            ttt.tt_matvec([c[p] for c in tcores], torch.tensor(x[p]),
                          _port_spec(spec)).numpy(), rtol=RTOL, atol=1e-6)


def test_batched_split_and_refusals():
    spec = ttt.PAPER_TONN_SPEC
    cores = [torch.zeros((3, *s)) for s in spec.core_shapes]
    with pytest.raises(ValueError, match="core stack P=3"):
        tref.tt_contract_batched_ref(torch.zeros(2, 4, 1024), cores, spec)
    # an explicit flag disambiguates a 3-D shared input
    y = tref.tt_contract_batched_ref(torch.zeros(2, 4, 1024), cores, spec,
                                     shared_x=True)
    assert tuple(y.shape) == (3, 2, 4, 1024)
    before = tttc.tt_contract_batched.launches
    tops.tt_linear_batched(torch.zeros(4, 1024), cores, spec)
    assert tttc.tt_contract_batched.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tttc.tt_contract_batched(torch.zeros(4, 1024), cores, spec)
    with pytest.raises(ValueError, match="CUDA"):
        tops.tt_linear_batched(torch.zeros(4, 1024, device="meta"),
                               [c.to("meta") for c in cores], spec)


@settings(deadline=None, max_examples=8)
@given(P=st.integers(1, 4), C=st.integers(1, 5), batch=st.integers(1, 12),
       shared_x=st.booleans())
def test_tt_linear_batched_multi_axis_property(P, C, batch, shared_x):
    """The port's counterpart of the reference's multi-axis property
    (``tests/test_properties.py``): extra batch axes (perturbations ×
    coefficients × points) flatten through the stacked chain and come
    back, equal to the flattened call bit for bit, for shared and
    per-entry inputs, the C == P case included (``shared_x`` decides it),
    and within ``RTOL`` of JAX's plain chain on the same arrays."""
    spec = jtt.auto_factorize(16, 32, L=2, max_rank=2)
    rng = np.random.RandomState(P * 100 + C * 10 + batch)
    cores = [rng.standard_normal((P, *s)).astype(np.float32)
             for s in spec.core_shapes]
    x = rng.standard_normal((C, batch, 32) if shared_x
                            else (P, C, batch, 32)).astype(np.float32)
    tcores = [torch.tensor(c) for c in cores]
    y = tops.tt_linear_batched(torch.tensor(x), tcores, _port_spec(spec),
                               shared_x=shared_x)
    assert tuple(y.shape) == (P, C, batch, 16)
    flat = x.reshape(-1, 32) if shared_x else x.reshape(P, -1, 32)
    y_flat = tops.tt_linear_batched(torch.tensor(flat), tcores,
                                    _port_spec(spec), shared_x=shared_x)
    assert torch.equal(y, y_flat.reshape(y.shape))
    want = jops.tt_linear_batched(jnp.asarray(x), tuple(map(jnp.asarray,
                                                            cores)),
                                  spec, mode="ref", shared_x=shared_x)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------- fiber body tiling

def _config_specs():
    """Every TTSpec the port's PINN configs build: the paper's table rows,
    ``pinn_config`` (hidden 1024) and ``pinn_reduced`` (hidden 64, L 3) of
    each registered PDE (black-scholes-100d's 101-wide input pads to 1024
    and to 104)."""
    from repro_torch import pde
    from repro_torch.configs import hjb_pinn
    from repro_torch.core import pinn
    cfgs = [hjb_pinn.TONN_OFFCHIP, hjb_pinn.TONN_ONCHIP,
            hjb_pinn.TONN_ONCHIP_FUSED, hjb_pinn.REDUCED]
    assert {"hjb-20d", "heat-20d", "black-scholes-100d"} <= set(
        pde.available())
    for name in pde.available():
        cfgs += [hjb_pinn.pinn_config(name, "tt"),
                 hjb_pinn.pinn_reduced(name, "tt")]
    return {(s.out_modes, s.in_modes, s.ranks): s
            for cfg in cfgs for s in pinn.TensorPinn(cfg).specs}


@pytest.mark.parametrize("rows_total", [None, 1, 231, 2048, 47_300, 65_536])
def test_fiber_tile_fits_every_spec_the_configs_build(rows_total):
    """The fiber body's tiling of every spec the configs build: within the
    fiber cap, the block's threads and shared memory, three blocks to an SM
    when more than one row fits, and no more rows per block than the launch
    needs to put three blocks on every SM."""
    specs = _config_specs()
    assert ttt.PAPER_TONN_SPEC in specs.values()
    assert tttc.FIBER_THREADS <= 1024
    for spec in specs.values():
        tile = tttc.fiber_tile(spec, rows_total)
        widths = [(r * n, m * rn) for r, m, n, rn in spec.core_shapes]
        assert len(tile.caps) == spec.L
        for (f_in, f_out), cap in zip(widths, tile.caps):
            assert max(f_in, f_out) <= cap <= tttc.MAX_FIBER
            assert cap in (4, 8, 16, 32)
        assert tile.stride % 32 == 0
        assert tile.stride >= tttc.chain_widest(spec)
        assert tile.buffers == (1 if all(a == b for a, b in widths) else 2)
        assert 1 <= tile.rows <= tttc.MAX_FIBER_ROWS
        assert tile.smem_bytes == 4 * (
            tttc._core_floats(spec) + sum(c * c for c in tile.caps)
            + tile.buffers * tile.rows * tile.stride)
        assert tile.smem_bytes <= tttc.SMEM_MAX_BYTES
        if tile.rows > 1:
            assert tile.smem_bytes <= tttc.SMEM_BLOCK_BUDGET
        if rows_total is not None:
            assert tile.rows <= max(1, -(-rows_total // (
                tttc.BLOCKS_PER_SM * tttc.H100_SMS)))


def test_fiber_tile_at_the_papers_spec():
    """One buffer in place (every step 8 → 8), 16 rows of 4 KB: three
    blocks of 66 KB share an SM; the served pool of 2048 rows takes 6 rows a
    block, 342 blocks, and the hidden layer's 11 × 4300 rows the full
    tile."""
    spec = ttt.PAPER_TONN_SPEC
    tile = tttc.fiber_tile(spec)
    assert (tile.rows, tile.stride, tile.buffers, tile.caps) == \
        (16, 1024, 1, (8, 8, 8, 8))
    assert tile.smem_bytes == 4 * (256 + 4 * 64 + 16 * 1024)
    assert tttc.fiber_tile(spec, 2048).rows == 6
    assert tttc.fiber_tile(spec, 11 * 4300) == tile
    assert tttc.fiber_tile(spec, 11 * 21).rows == 1


@pytest.mark.parametrize("out_dim,in_dim,L,rank", [(96, 128, 2, 8),
                                                   (48, 60, 3, 16),
                                                   (256, 512, 3, 8)])
def test_fiber_tile_refuses_a_fiber_past_the_cap(out_dim, in_dim, L, rank):
    """A spec with a fiber wider than 32 raises; nothing falls back."""
    spec = ttt.auto_factorize(out_dim, in_dim, L=L, max_rank=rank)
    widths = [(r * n, m * rn) for r, m, n, rn in spec.core_shapes]
    assert max(max(w) for w in widths) > tttc.MAX_FIBER
    with pytest.raises(ValueError, match="at most 32"):
        tttc.fiber_tile(spec)
    with pytest.raises(ValueError, match="at most 32"):
        tttc.fiber_tile(spec, 100)


def test_fiber_tile_refuses_a_row_past_shared_memory():
    """A row wider than a block's shared memory raises too (fibers of
    4 → 4, 4^8 = 65,536 floats a row)."""
    spec = ttt.TTSpec((4,) * 8, (4,) * 8, (1,) * 9)
    assert 4 * tttc.chain_widest(spec) > tttc.SMEM_MAX_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        tttc.fiber_tile(spec)


# ------------------------------------------------------------------- TT-SVD

def test_tt_svd_full_rank_roundtrip():
    """``test_core``'s case: a rank the unfolding cannot reach clamps, and
    the cores rebuild the matrix."""
    spec = ttt.TTSpec((3, 4), (5, 2), (1, 12, 1))
    w = np.random.RandomState(0).randn(12, 10)
    cores = ttt.tt_svd(w, spec)
    assert [tuple(c.shape) for c in cores] == list(spec.core_shapes)
    assert all(c.dtype == torch.float32 for c in cores)
    np.testing.assert_allclose(ttt.tt_to_full(cores, spec).numpy(), w,
                               atol=1e-5)
    assert ttt.tt_num_params(spec) == jtt.tt_num_params(spec) == 276


def test_tt_svd_truncation_is_best_effort():
    """``test_core``'s case: a rank-4 matrix at TT-rank 4 rebuilds within
    the discarded singular values (relative error below 0.9)."""
    rs = np.random.RandomState(1)
    w = rs.randn(16, 4) @ rs.randn(4, 16)
    spec = ttt.TTSpec((4, 4), (4, 4), (1, 4, 1))
    w2 = ttt.tt_to_full(ttt.tt_svd(torch.tensor(w), spec), spec).numpy()
    assert np.linalg.norm(w2 - w) / np.linalg.norm(w) < 0.9


@pytest.mark.parametrize("label", ["reduced-64", "rank4-256x512",
                                   "nonsquare-96x128"])
def test_tt_svd_cores_match_jax(label):
    """The same float64 SVDs as the reference: the cores equal JAX's within
    1e-6 (both round the same float64 values to f32; only the two LAPACK
    calls could differ); ``device=`` puts them where asked."""
    spec = CHAIN_CASES[label][0]
    w = np.random.RandomState(len(label)).randn(spec.out_dim, spec.in_dim)
    want = jtt.tt_svd(w, spec)
    got = ttt.tt_svd(w, spec, device="cpu")
    assert len(got) == spec.L
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="shape mismatch"):
        ttt.tt_svd(w[:, 1:], spec)
