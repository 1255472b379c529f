"""The wide-mesh routes of ``kernels/mesh_apply.py`` on the CPU: which layouts
route A (warp rows) takes, which route ``wide_route`` picks at onn's shapes,
route A's per-level modes and trig records against the gather plan and
tables of ``core.photonic``, and a model of route A's lane algorithm in
plain torch.

The CUDA kernels run on the card only (``tests/test_torch_gpu.py``); what
they read is built here by plain Python: ``level_modes`` (bit 0 a level's
pair parity, bit 1 "partial") and ``trig_records``, the plain twin of the
trig prologue.  ``_route_a_model`` repeats ``mesh_rows_kernel``'s
arithmetic lane by lane on those records — register pairs, the lane-edge
shuffles, lane 0's ``-x[0]`` stand-in, the absent entries — with every
product and sum a torch op of its own, so it is held to
``photonic.mesh_apply_stacked`` bit for bit, signed zeros included.  The
records are held bit for bit to ``photonic.mesh_gather_tables`` (both take
sin and cos from torch on the CPU).  No tolerance anywhere in this file.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core import photonic as tph
from repro_torch.kernels import mesh_apply as tmesh


def _reck(P, seed=0):
    q, _ = np.linalg.qr(np.random.RandomState(seed).standard_normal((P, P)))
    return tph.decompose_orthogonal(q)[0]


def _layout(kind, P):
    return {"rect": tph.rectangular_layout, "reck": _reck,
            "skew": chip_smoke.skew_layout}[kind](P)


@pytest.mark.parametrize("kind,P", [("rect", 139), ("rect", 160),
                                    ("rect", 1024), ("rect", 7),
                                    ("reck", 9), ("reck", 40),
                                    ("reck", 100)])
def test_repo_layouts_pair_adjacent_wires(kind, P):
    """Every rectangular and Reck layout pairs adjacent wires, one parity a
    level: route A takes it."""
    layout = _layout(kind, P)
    assert tmesh.adjacent_pairs(layout)
    modes = tmesh.level_modes(layout)
    assert modes.shape == (layout.levels,) and modes.dtype == np.int32


def test_other_layouts_take_the_owner_walk():
    """Pairs (a, a+2), or adjacent pairs of both parities in one level, are
    not route A's: the owner walk takes them at any batch; a pair listed
    upper wire first is still adjacent."""
    skew = chip_smoke.skew_layout(160)
    mixed = tph.schedule_ops(6, [(0, 1), (3, 4)])
    flipped = tph.schedule_ops(6, [(1, 0), (3, 2), (2, 1)])
    assert mixed.levels == 1
    for layout in (skew, mixed):
        assert not tmesh.adjacent_pairs(layout)
        for rows in (1, 10**4):
            assert tmesh.wide_route(layout, 3, rows) == "owner_walk"
        with pytest.raises(ValueError, match="adjacent"):
            tmesh.level_modes(layout)
    assert tmesh.mesh_design(skew) == "wide"
    assert tmesh.adjacent_pairs(flipped)


def test_wide_route_at_onn_shapes():
    """onn's hidden layer (11 x 4300 rows per entry) takes route B, layer
    0's U mesh on the 100 rows and the 21 columns route A; at S = 1 a
    validation forward's 1000 rows route A, the served pool's 2048 and a
    sequential loss evaluation's 4300 route B; ports past 1024 or not a
    multiple of 4 keep route A or the owner walk."""
    wide = tph.rectangular_layout(1024)
    assert tmesh.mesh_design(wide) == "wide"
    assert tmesh.wide_route(wide, 11, 4300) == "dense"
    assert tmesh.wide_route(wide, 11, 100) == "warp_rows"
    assert tmesh.wide_route(wide, 11, 21) == "warp_rows"
    assert tmesh.wide_route(wide, 1, 1000) == "warp_rows"
    assert tmesh.wide_route(wide, 1, 2048) == "dense"
    assert tmesh.wide_route(wide, 1, 4300) == "dense"
    threshold = int(np.ceil(tmesh.DENSE_MIN_ROWS_PER_PORT * 1024))
    for S in (11, 3, 1):
        assert tmesh.wide_route(wide, S, threshold) == "dense"
        assert tmesh.wide_route(wide, S, threshold - 1) == "warp_rows"
    assert tmesh.wide_route(tph.rectangular_layout(139), 3, 10**4) == \
        "warp_rows"
    assert tmesh.wide_route(tph.rectangular_layout(160), 3, 777) == "dense"
    assert tmesh.wide_route(tph.rectangular_layout(1100), 1, 4) == \
        "owner_walk"
    assert [tmesh.lane_width(P) for P in (139, 256, 257, 1024, 1025)] == \
        [8, 8, 16, 32, None]


def test_rows_config_at_onn_shapes():
    """Four rows a warp where the batch fills 8 warps a multiprocessor (132
    of an H100), one row a warp at layer 0's batches; blocks of 4 warps,
    fewer where the rows run out."""
    wide = tph.rectangular_layout(1024)
    assert tmesh.rows_config(wide, 11, 4300, 132) == (32, 4, 4)
    assert tmesh.rows_config(wide, 11, 1024, 132) == (32, 4, 4)
    assert tmesh.rows_config(wide, 11, 100, 132) == (32, 1, 4)
    assert tmesh.rows_config(wide, 11, 21, 132) == (32, 1, 4)
    assert tmesh.rows_config(wide, 1, 2048, 132) == (32, 1, 4)
    assert tmesh.rows_config(wide, 1, 4300, 132) == (32, 4, 4)
    assert tmesh.rows_config(wide, 1, 3, 132) == (32, 1, 3)
    assert tmesh.rows_config(tph.rectangular_layout(160), 3, 777,
                             132) == (8, 2, 4)


@pytest.mark.parametrize("kind,P", [("rect", 139), ("rect", 160),
                                    ("rect", 64), ("rect", 300),
                                    ("reck", 40)])
def test_level_modes_against_the_gather_plan(kind, P):
    """Bit 0 the parity of a level's pairs; bit 1 set exactly where an
    in-range brick pair of that parity is missing, or wire P-1 is unpaired
    without ending a lane.  Rectangular meshes whose width W divides
    leave no level partial."""
    layout = _layout(kind, P)
    perm = tph.mesh_gather_plan(layout)[0]
    W = tmesh.lane_width(P)
    modes = tmesh.level_modes(layout)
    for c in range(layout.levels):
        lo = np.flatnonzero(perm[c] > np.arange(P))
        p = int(lo[0] % 2) if len(lo) else 0
        assert (lo % 2 == p).all() and (perm[c, lo] == lo + 1).all()
        brick = np.arange(p, P - 1, 2)
        partial = len(lo) != len(brick) or ((P - 1) % 2 == p
                                             and P % W != 0)
        assert modes[c] == p | 2 * int(partial), c
    if kind == "rect" and P % W == 0:
        assert (modes >> 1).sum() == 0


@pytest.mark.parametrize("kind,P", [("rect", 139), ("rect", 64),
                                    ("rect", 300), ("reck", 40)])
def test_rows_plan_matches_the_gather_plan(kind, P):
    """Route A's host-built plan against ``mesh_gather_plan``: each entry
    that holds a wire carries that wire's slot and sign (a pair's lower
    wire, else its unpaired wire), its absent bit is set exactly where its
    two wires are no pair, every wire of every level is held by exactly
    one lane's entries, and the mode is ``level_modes``'."""
    layout = _layout(kind, P)
    L, W = layout.levels, tmesh.lane_width(P)
    E = W // 2 + 1
    perm, slot, sign = tph.mesh_gather_plan(layout)
    plan = tmesh.rows_plan(layout).astype(np.int64) & 0xffffffff
    assert plan.shape == (L, E * 32 + 33)
    modes = tmesh.level_modes(layout)
    assert (plan[:, -1] == modes).all()
    for cl in range(L):
        p = modes[cl] & 1
        held = np.zeros(P, dtype=int)
        for t in range(32):
            absent = plan[cl, E * 32 + t]
            for i in range(E):
                code = plan[cl, i * 32 + t]
                lo = t * W + 2 * i - p
                pair = 0 <= lo and lo + 1 < P and perm[cl, lo] == lo + 1
                assert ((absent >> i) & 1) == (not pair)
                wires = [w for w in (lo, lo + 1) if 0 <= w < P]
                assert bool(code & tmesh.WIRE_BIT) == bool(wires)
                if not wires:
                    continue
                w = wires[0]
                assert code & 0xffffff == slot[cl, w]
                sg = {0: 0.0, 1: 1.0, 2: -1.0}[(code >> 24) & 3]
                assert sg == sign[cl, w]
                # the edge entries of a parity-1 level are held by both
                # lanes at a crossing; count each wire once, at its lane
                held[[w for w in wires if w // W == t]] += 1
        assert (held == 1).all(), cl


def _records(layout, phases, transpose):
    rec = tmesh.trig_records(layout, phases, transpose)
    W = tmesh.lane_width(layout.ports)
    E = W // 2 + 1
    bits = rec.view(torch.int32)
    return (rec[..., :E * 64].reshape(*rec.shape[:2], E, 32, 2),
            bits[..., E * 64:E * 64 + 32], bits[..., E * 64 + 32])


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kind,P", [("rect", 139), ("rect", 160),
                                    ("rect", 300), ("reck", 40)])
def test_trig_records_match_gather_tables(kind, P, transpose):
    """Each wire's (C, S) and partner read back from route A's records
    equal ``mesh_gather_tables`` and ``mesh_gather_plan`` bit for bit:
    a present entry (c, s) is (c, s) on its lower wire and (c, -s) on its
    upper, an absent one (1, S) on each of its wires, partnered with
    itself."""
    layout = _layout(kind, P)
    L, W = layout.levels, tmesh.lane_width(P)
    gen = torch.Generator().manual_seed(P)
    phases = torch.randn((2, *layout.phase_shape()), generator=gen)
    ent, absent, modes = _records(layout, phases, transpose)
    assert torch.equal(modes, torch.as_tensor(
        tmesh.level_modes(layout)).expand(2, L))
    cos, sin = tph.mesh_gather_tables(layout, phases, transpose)
    if transpose:                        # back to stored level order
        cos, sin = torch.flip(cos, (-2,)), torch.flip(sin, (-2,))
    perm = tph.mesh_gather_plan(layout)[0]
    C = torch.full((2, L, P), float("nan"))
    S = torch.full((2, L, P), float("nan"))
    partner = np.full((L, P), -1)
    for cl in range(L):
        p = int(modes[0, cl]) & 1
        for t in range(32):
            for i in range(W // 2 + 1):
                lo = t * W + 2 * i - p
                ab = (int(absent[0, cl, t]) >> i) & 1
                for w, other, sgn in ((lo, lo + 1, 1.0), (lo + 1, lo, -1.0)):
                    if not 0 <= w < P:
                        continue
                    c, s = ent[:, cl, i, t, 0], ent[:, cl, i, t, 1]
                    C[:, cl, w] = c
                    S[:, cl, w] = s if ab else sgn * s
                    partner[cl, w] = w if ab else other
    assert (partner == perm).all()
    assert torch.equal(C, cos) and torch.equal(S, sin)
    assert torch.equal(torch.signbit(S), torch.signbit(sin))


def _route_a_model(layout, phases, diag, x, transpose):
    """``mesh_rows_kernel``'s arithmetic in plain torch, lanes as an axis:
    x (B, P) or (S, B, P) → (S, B, P)."""
    S, P, L = phases.shape[0], layout.ports, layout.levels
    W = tmesh.lane_width(P)
    H = W // 2
    ent, absent, modes = _records(layout, phases, transpose)
    x = x.expand(S, *x.shape) if x.ndim == 2 else x
    d = diag.expand(S, P) if diag.ndim == 1 else diag
    B = x.shape[1]
    v = torch.zeros((S, B, 32 * W))
    v[..., :P] = x if transpose else x * d[:, None]
    v = v.reshape(S, B, 32, W)
    lane = torch.arange(32)
    first = lane == 0
    last = (lane == P // W - 1) & (P % W == 0)

    def pair(e, ab, j, i, partial):
        c, s = e[:, i, :, 0][:, None], e[:, i, :, 1][:, None]
        a = ((((ab >> i) & 1) != 0) & partial)[:, None]
        lo, hi = v[..., j].clone(), v[..., j + 1].clone()
        v[..., j] = c * lo + s * torch.where(a, lo, hi)
        v[..., j + 1] = torch.where(a, c * hi + s * hi, c * hi - s * lo)

    for step in range(L):
        cl = L - 1 - step if transpose else step
        mode = int(modes[0, cl])
        partial = bool(mode & 2)
        e, ab = ent[:, cl], absent[:, cl]
        if mode & 1 == 0:
            for i in range(H):
                pair(e, ab, 2 * i, i, partial)
            continue
        x0, xl = v[..., 0].clone(), v[..., W - 1].clone()
        left = torch.cat([xl[..., :1], xl[..., :-1]], -1)      # shfl_up
        right = torch.cat([x0[..., 1:], x0[..., -1:]], -1)     # shfl_down
        c, s = e[:, 0, :, 0][:, None], e[:, 0, :, 1][:, None]
        if partial:
            a0 = ((ab & 1) != 0)[:, None]
            v[..., 0] = torch.where(a0, c * x0 + s * x0, c * x0 - s * left)
        else:
            v[..., 0] = c * x0 - s * torch.where(first, -x0, left)
        for i in range(1, H):
            pair(e, ab, 2 * i - 1, i, partial)
        c, s = e[:, H, :, 0][:, None], e[:, H, :, 1][:, None]
        self_ = ((((ab >> H) & 1) != 0)[:, None] if partial
                 else last.expand(S, 1, 32))
        v[..., W - 1] = c * xl + s * torch.where(self_, xl, right)
    y = v.reshape(S, B, 32 * W)[..., :P]
    return y * d[:, None] if transpose else y


# label -> (layout kind, ports, S, B, shared x, transpose, signed zeros)
MODEL_CASES = {
    "rect139-tr": ("rect", 139, 2, 3, False, True, False),
    "rect160-shared": ("rect", 160, 2, 5, True, False, False),
    "rect300": ("rect", 300, 1, 4, False, False, False),
    "rect1024-tr": ("rect", 1024, 1, 2, False, True, False),
    "reck40": ("reck", 40, 2, 3, False, False, False),
    "reck60-zeros-tr": ("reck", 60, 2, 3, True, True, True),
    "rect64-zeros": ("rect", 64, 2, 4, False, False, True),
}


@pytest.mark.parametrize("label", sorted(MODEL_CASES))
def test_route_a_model_matches_plain_bitwise(label):
    """Route A's lane algorithm on its records gives the plain gather
    form's bits, signs of zeros included (unpaired wires keep 1·x + ±0·x,
    lane 0's wire 0 through -x[0], the last lane's wire P-1 itself)."""
    kind, P, S, B, shared, transpose, zeros = MODEL_CASES[label]
    layout = _layout(kind, P)
    gen = torch.Generator().manual_seed(len(label))
    phases = torch.randn((S, *layout.phase_shape()), generator=gen)
    diag = torch.where(torch.rand((S, P), generator=gen) < 0.5, -1.0, 1.0)
    x = torch.randn((B, P) if shared else (S, B, P), generator=gen)
    if zeros:
        x[..., P // 2:] = -0.0
        x[..., 1::7] = 0.0
        phases[..., 0] = 0.0
    for d in (diag, diag[0]):
        got = _route_a_model(layout, phases, d, x, transpose)
        want = tph.mesh_apply_stacked(layout, phases, d, x, transpose)
        assert torch.equal(got, want)
        assert torch.equal(torch.signbit(got), torch.signbit(want))


def test_route_a_model_catches_a_wrong_edge():
    """The model is sharp: lane 0 standing in +x[0] for wire 0's left
    partner moves signed zeros off the plain bits."""
    layout = tph.rectangular_layout(64)
    gen = torch.Generator().manual_seed(0)
    phases = torch.randn((1, *layout.phase_shape()), generator=gen)
    phases[..., 0] = 0.0
    x = torch.full((1, 3, 64), -0.0)
    diag = torch.ones(64)
    want = tph.mesh_apply_stacked(layout, phases, diag, x)
    ent, absent, modes = _records(layout, phases, False)
    # wire 0's unpaired update with its own value as partner, +x[0]:
    # 1·(-0) - (+0)·(-0) = +0, where the plain 1·(-0) + (+0)·(-0) = -0
    c, s = ent[0, 1, 0, 0, 0], ent[0, 1, 0, 0, 1]
    x0 = torch.tensor(-0.0)
    assert torch.signbit(c * x0 + s * x0) and not torch.signbit(
        c * x0 - s * x0)
    assert torch.equal(torch.signbit(_route_a_model(layout, phases, diag, x,
                                                    False)),
                       torch.signbit(want))
