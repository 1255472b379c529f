"""The layout and summation order of ``tt_contract_grad`` (the TT chain's
backward kernel), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``); here
the Python mirror of its layout (``grad_tile``: saved forward states, rows a
block, blocks an SM, shared memory) and of its summation depth
(``_grad_depth``, behind ``grad_bound``) are held to what the source lays
out, and the plain version it is checked against is held to ``jax.vjp`` of
the JAX package's chain at the shapes whose states the kernel cannot all
keep (tolerance ``1e-5·max|want| + 1e-6``: the same f32 products summed in
another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tt as jtt
from repro_torch.configs import hjb_pinn
from repro_torch.core import pinn as tpinn
from repro_torch.core import tt
from repro_torch.kernels import ref
from repro_torch.kernels import tt_contract as ttc

PAPER = tt.PAPER_TONN_SPEC
WIDE = tt.auto_factorize(4096, 4096, L=4, max_rank=2)
SPECS = {
    "paper": PAPER,
    "reduced": tt.auto_factorize(64, 64, L=3, max_rank=2),
    "rank4": tt.auto_factorize(256, 512, L=3, max_rank=4),
    "wide": WIDE,
    "odd": tt.TTSpec(out_modes=(3, 5, 2), in_modes=(4, 3, 2),
                     ranks=(1, 3, 2, 1)),
    "single": tt.TTSpec(out_modes=(4,), in_modes=(8,), ranks=(1, 1)),
}
# the BP launches the chip checks: (spec, rows)
LAUNCHES = [(PAPER, 21), (PAPER, 100), (PAPER, 4300),
            (SPECS["reduced"], 1000), (SPECS["rank4"], 777), (WIDE, 777)]
SLOTS_PER_BLOCK_SM = 228 * 1024


def _config_specs():
    """Every TT spec the port's PINN configs build (the Table-1 rows, the
    fused path, the reduced one, and ``pinn_config`` / ``pinn_reduced``
    for tt and tonn)."""
    cfgs = [hjb_pinn.TONN_OFFCHIP, hjb_pinn.TONN_ONCHIP,
            hjb_pinn.TONN_ONCHIP_FUSED, hjb_pinn.REDUCED]
    for mode in ("tt", "tonn"):
        cfgs += [hjb_pinn.pinn_config(mode=mode),
                 hjb_pinn.pinn_reduced(mode=mode)]
    return sorted({s for c in cfgs for s in tpinn.TensorPinn(c).specs},
                  key=lambda s: (s.in_dim, s.out_dim, s.ranks))


def test_config_specs_get_a_layout():
    """Each spec the configs build gets a layout; the paper's hidden layer
    recomputes no forward step (it keeps L - 1 states, x read again) at
    three blocks an SM, four rows a tile; the list is not empty."""
    specs = _config_specs()
    assert PAPER in specs and len(specs) >= 2
    for spec in specs:
        for rows in (21, 100, 4300):
            tile = ttc.grad_tile(spec, rows)
            assert ttc.min_saved(spec) <= tile.saved <= spec.L
            assert tile.buffers == tile.saved + 1
    tile = ttc.grad_tile(PAPER, 4300)
    assert (tile.saved, tile.blocks_per_sm, tile.rows) == (PAPER.L - 1, 3, 4)
    # layer 0's launches: a row a tile either way, so all four states
    assert ttc.grad_tile(PAPER, 100).saved == PAPER.L


@pytest.mark.parametrize("spec,rows", LAUNCHES,
                         ids=[f"{s.in_dim}-{b}" for s, b in LAUNCHES])
def test_every_tile_fits(spec, rows):
    """Shared memory: the block inside Hopper's 232,448 bytes and its
    blocks an SM inside the SM's 228 KB; the tile is what
    ``grad_smem_bytes`` sizes."""
    tile = ttc.grad_tile(spec, rows)
    assert tile.smem_bytes == ttc.grad_smem_bytes(spec, tile.rows,
                                                  tile.saved)
    assert tile.smem_bytes <= ttc.SMEM_MAX_BYTES
    assert tile.blocks_per_sm * (tile.smem_bytes + 1024) <= \
        SLOTS_PER_BLOCK_SM
    assert 1 <= tile.rows <= min(rows, ttc.MAX_FIBER_ROWS)


def test_wider_rows_save_fewer_states():
    """The paper's rows (1024 floats) keep all four states; the 4096-wide
    spec's rows (8192 floats, steps out of place) keep two, at two blocks
    an SM, and recompute the rest; the fewest the kernel takes is 1 for
    in-place chains and 2 otherwise."""
    paper, wide = ttc.grad_tile(PAPER, 777), ttc.grad_tile(WIDE, 777)
    assert wide.stride == 8 * paper.stride
    assert paper.saved == 4 and wide.saved == 2 < WIDE.L
    assert wide.blocks_per_sm < paper.blocks_per_sm
    assert ttc.min_saved(PAPER) == 1 and ttc.min_saved(WIDE) == 2
    assert ttc.min_saved(SPECS["single"]) == 1


def test_hidden_call_fills_whole_waves():
    """The hidden call's 4300 rows: one block a slot, each walking its
    tiles, at least 90% of the slots' tile rounds busy (the parent's 8
    rows a block filled 68% of its waves), and no other rows a tile that
    fits fills the rounds with less cost."""
    tile = ttc.grad_tile(PAPER, 4300)
    slots = tile.blocks_per_sm * ttc.H100_SMS
    tiles, blocks = ttc.grad_grid(tile, 4300)
    assert blocks == slots
    waves = -(-tiles // slots)
    assert 4300 / (waves * slots * tile.rows) >= 0.9
    most = ttc.grad_tile(PAPER).rows
    for r in range(1, most + 1):
        assert waves * (tile.rows + 1) <= -(-(-(-4300 // r)) // slots) * (
            r + 1)
    # layer 0 spreads its rows: a block a row
    assert ttc.grad_tile(PAPER, 21).rows == ttc.grad_tile(PAPER, 100).rows \
        == 1


def _chunked_depth(n: int) -> int:
    """Depths through ``SUM_CHUNK`` values at a time added pairwise (None
    for the zeros that pad a chunk: adding them rounds nothing), the
    chunks in order."""
    depth = 0
    for b0 in range(0, n, ttc.SUM_CHUNK):
        d = [0 if b0 + i < n else None for i in range(ttc.SUM_CHUNK)]
        w = 1
        while w < ttc.SUM_CHUNK:
            for i in range(0, ttc.SUM_CHUNK, 2 * w):
                a, b = d[i], d[i + w]
                d[i] = a if b is None else b if a is None else max(a, b) + 1
            w *= 2
        depth = d[0] if b0 == 0 else max(depth, d[0]) + 1
    return depth


@pytest.mark.parametrize("floats", [256, 768, 30])
@pytest.mark.parametrize("n", [1, 2, 3, 15, 16, 17, 38, 100, 1000])
def test_sum_depth_matches_the_chunked_order(n, floats):
    """``_sum_depth`` bounds the most additions a partial passes through in
    ``sum_partials``' order, counted by running that order on depths: the
    blocks split into ``parts`` ranges (``p*n // parts`` on), each range
    chunked, then the parts added in order (part 0 through parts - 1
    additions, part p > 0 through parts - p); it is at most one over."""
    cols = floats // 4 if floats % 4 == 0 else floats
    parts = 1 if cols >= 128 else min(128 // cols, n)
    lengths = [(p + 1) * n // parts - p * n // parts for p in range(parts)]
    assert min(lengths) >= 1 and sum(lengths) == n
    depth = max(_chunked_depth(m) + (parts - 1 if p == 0 else parts - p)
                for p, m in enumerate(lengths))
    assert depth <= ttc._sum_depth(n, floats) <= depth + 1


def test_grad_depth_follows_the_order():
    """The depth at the paper's hidden call (4 rows a tile, 1075 tiles over
    396 blocks in 13 groups of 32): 4 fibers a thread, 5 butterfly rounds,
    3 warp sums, 2 more tiles a block, 5 + 4 for the two levels (256
    floats: 64 float4 columns, 2 parts of 16 and of 7); layer 0's 21 rows:
    a tile a block, one group of 21 (2 parts of 11: 4 + 1).  It grows with
    the rows a tile, the tiles a block and the blocks; a 16-wide step (the
    wide spec's) adds a row's fibers over one warp's lanes."""
    tile = ttc.grad_tile(PAPER, 4300)
    assert ttc.grad_grid(tile, 4300) == (1075, 396)
    assert ttc.grad_groups(396) == (32, 13)
    assert ttc.grad_groups(21) == (21, 1)
    assert (ttc._sum_depth(32, 256), ttc._sum_depth(13, 256)) == (5, 4)
    assert ttc._grad_depth(PAPER, 0, 4, 1075, 396) == 4 + 5 + 3 + 2 + 5 + 4
    assert ttc._grad_depth(PAPER, 0, 1, 21, 21) == 1 + 5 + 3 + 0 + 5 + 0
    assert ttc._grad_depth(PAPER, 2, 5, 1075, 396) > \
        ttc._grad_depth(PAPER, 2, 4, 1075, 396)
    assert ttc._grad_depth(PAPER, 2, 4, 4000, 396) > \
        ttc._grad_depth(PAPER, 2, 4, 1075, 396)
    assert ttc._grad_depth(PAPER, 2, 4, 40_000, 40_000) > \
        ttc._grad_depth(PAPER, 2, 4, 396, 396)
    # step 1 of the wide spec: f_in = f_out = 16, four 8x8 tiles a warp
    # each, 512 fibers a row over 32 lanes; 777 tiles over 264 blocks in
    # 9 groups of 32 (768 floats: 192 columns, one part)
    wide = ttc.grad_tile(WIDE, 777)
    assert ttc.grad_grid(wide, 777) == (777, 264)
    assert ttc.grad_groups(264) == (32, 9)
    assert ttc._grad_depth(WIDE, 1, 1, 777, 264) == 16 + 5 + 0 + 2 + \
        ttc._sum_depth(32, WIDE.num_params) + \
        ttc._sum_depth(9, WIDE.num_params)


def test_grad_bound_grows_with_depth():
    """``grad_bound`` is ``1.01·(h_k + c)·2^-24·S_k`` at the launch's
    tiling: doubling the rows keeps S_k's shape and moves h_k."""
    spec = SPECS["reduced"]
    gen = torch.Generator().manual_seed(3)
    cores = tt.tt_init(gen, spec)
    x = torch.randn((40, spec.in_dim), generator=gen)
    dy = torch.randn((40, spec.out_dim), generator=gen)
    tile = ttc.grad_tile(spec, 40)
    tiles, blocks = ttc.grad_grid(tile, 40)
    c = 2 * sum(max(r * n, m * rn) for r, m, n, rn in spec.core_shapes)
    _, sums = ref.tt_contract_grad_ref(
        x.double().abs(), [g.double().abs() for g in cores], spec,
        dy.double().abs(), need_dx=False)
    for k, (b, s) in enumerate(zip(ttc.grad_bound(x, cores, spec, dy),
                                   sums)):
        h = ttc._grad_depth(spec, k, tile.rows, tiles, blocks)
        assert torch.allclose(b, 1.01 * (h + c) * 2.0 ** -24 * s,
                              rtol=1e-12, atol=0)
        assert (b > 0).all()


def test_tickets_are_cached_zero_and_grow():
    """One zeroed int32 ticket buffer a device, reused by every call that
    fits it, replaced by a larger zeroed one when a call needs more."""
    dev = torch.device("cpu")
    ttc._TICKETS.pop(dev, None)
    a = ttc._tickets(dev, 3)
    assert a.dtype == torch.int32 and (a == 0).all() and a.numel() >= 3
    assert ttc._tickets(dev, 2) is a
    b = ttc._tickets(dev, a.numel() + 1)
    assert b is not a and (b == 0).all() and b.numel() > a.numel()
    assert ttc._tickets(dev, 1) is b
    ttc._TICKETS.pop(dev, None)


def test_grad_tile_is_cached():
    """The wrapper asks for the layout on every call: it is computed once
    per (spec, rows)."""
    assert ttc.grad_tile(PAPER, 4300) is ttc.grad_tile(PAPER, 4300)


def test_wrapper_refuses_cpu_tensors():
    spec = SPECS["reduced"]
    cores = [torch.zeros(s) for s in spec.core_shapes]
    with pytest.raises(ValueError, match="CUDA"):
        ttc.tt_contract_grad(torch.zeros(2, spec.in_dim), cores, spec,
                             torch.zeros(2, spec.out_dim))


@pytest.mark.parametrize("label", ["wide", "odd", "single"])
def test_plain_grad_matches_jax_where_states_are_recomputed(label):
    """The plain version the kernel is held to, against ``jax.vjp`` of the
    JAX package's chain, at the specs whose steps are not in place or
    whose rows are too wide to keep every state."""
    spec = SPECS[label]
    rng = np.random.RandomState(len(label))
    cores = [(rng.standard_normal(s) * 0.3).astype(np.float32)
             for s in spec.core_shapes]
    x = rng.standard_normal((3, spec.in_dim)).astype(np.float32)
    dy = rng.standard_normal((3, spec.out_dim)).astype(np.float32)
    dx, dgs = ref.tt_contract_grad_ref(torch.tensor(x),
                                       [torch.tensor(c) for c in cores],
                                       spec, torch.tensor(dy))
    jspec = jtt.TTSpec(spec.out_modes, spec.in_modes, spec.ranks)
    _, vjp = jax.vjp(lambda xx, cs: jtt.tt_matvec(cs, xx, jspec),
                     jnp.asarray(x), [jnp.asarray(c) for c in cores])
    jdx, jdg = vjp(jnp.asarray(dy))
    for got, want in zip([dx, *dgs], [jdx, *jdg]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max() + 1e-6)
    assert math.prod(dx.shape) == 3 * spec.in_dim
