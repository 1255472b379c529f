"""The warp-rows backward of ``kernels/mesh_apply.py`` on the CPU: the
backward's dispatch (``grad_design``) and launch sizing
(``grad_rows_config``, shared memory, scratch) at the widths around the
resident backward's limit and at onn's, the slot map (``grad_slot_map``)
against the layouts' MZIs, and a model of the kernel's lane algorithm in
plain torch held to ``ref.mesh_apply_grad_ref``.

The CUDA kernel (``csrc/mesh_apply.cu::mesh_rows_grad_kernel``) runs on the
card only (``tests/test_torch_gpu.py``, ``chip_smoke.py``'s ``mesh-grad``).
``_route_a_grad_model`` repeats its arithmetic lane by lane: route A's
level on the records of the trig prologue with the opposite transpose,
walked in the opposite order, undoes a level on y and on the gradient g;
before that each owned pair's phase term ``g_lo·y_hi − g_hi·y_lo`` is
summed over the rows, kept at its word (``term_word``), and written,
signed, to the slot whose map names that word.  dx
is the plain version's bits (the same products and sums, ``c·y − s·q`` and
``c·y + (−s)·q`` round alike); dphases within ``1e-5·max|plain| + 1e-6``
(the phase term taken from the level's output instead of its recovered
input, summed in another order; measured ≤ 2e-7 of max|plain|).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core import photonic as tph
from repro_torch.kernels import mesh_apply as tmesh
from repro_torch.kernels import ref
from test_torch_mesh_grad import one_thread  # noqa: F401 (a fixture)

SMS = 132                                  # an H100's multiprocessors


def _reck(P, seed=0):
    q, _ = np.linalg.qr(np.random.RandomState(seed).standard_normal((P, P)))
    return tph.decompose_orthogonal(q)[0]


def _layout(kind, P):
    return {"rect": tph.rectangular_layout, "reck": _reck}[kind](P)


@pytest.mark.parametrize("P,design", [(16, "resident"), (138, "resident"),
                                      (139, "warp_rows"), (144, "warp_rows"),
                                      (1024, "warp_rows")])
def test_grad_design_and_sizing(P, design):
    """The resident backward up to 138 ports, the warp-rows one from 139
    to 1024: its slot map holds every MZI of every level once and nothing
    else, its block fits shared memory at every onn launch's rows, and its
    scratch is the block columns' partials, one per row tile of warps·R
    rows (at 1024 ports on 4300 rows: 8 warps of 2 rows, 269 columns,
    0.53 GiB)."""
    layout = tph.rectangular_layout(P)
    assert tmesh.grad_design(layout) == design
    if design == "resident":
        return
    smap = tmesh.grad_slot_map(layout)
    W = tmesh.lane_width(P)
    assert smap.shape == (layout.levels, -(-layout.slots // 4) * 4)
    assert ((smap >= 0) == np.pad(layout.mask, ((0, 0), (
        0, smap.shape[1] - layout.slots)))).all()
    assert ((smap[smap >= 0] & (tmesh.MAP_NEG - 1)) < (W // 2 + 1) * 32).all()
    for S, rows in ((1, 21), (1, 100), (3, 777), (1, 4300)):
        W_, R, warps, cols = tmesh.grad_rows_config(layout, S, rows, SMS)
        assert W_ == W and R in (1, 2) and 1 <= warps <= 16
        assert 32 * warps * (2 if W * R > 32 else 1) <= 512
        assert cols == -(-rows // (warps * R))
        assert tmesh.grad_rows_smem_bytes(W, warps, smap.shape[1]) <= \
            tmesh.SMEM_MAX_BYTES
        scratch = tmesh.grad_scratch_bytes(layout, S, rows, SMS)
        assert scratch == 4 * ((cols * S * layout.levels * layout.slots
                                if cols > 1 else 0)
                               + S * layout.levels * tmesh.record_floats(W))
    if P == 1024:
        assert tmesh.grad_rows_config(layout, 1, 4300, SMS) == (32, 2, 8, 269)
        assert tmesh.grad_rows_config(layout, 1, 100, SMS) == (32, 1, 4, 25)
        assert 0.5 < tmesh.grad_scratch_bytes(layout, 1, 4300, SMS) / 2**30 \
            < 0.55


def test_layouts_without_a_backward_name_item_6c3():
    """Past 1024 ports, or pairs of wires that are not adjacent: the owner
    walk's layouts have no backward; the dispatch says so (item 6c-3)."""
    for layout in (tph.rectangular_layout(1040), chip_smoke.skew_layout(160)):
        assert tmesh.wide_route(layout, 1, 100) == "owner_walk"
        assert tmesh.grad_design(layout) is None
        with pytest.raises(ValueError, match="item 6c-3"):
            tmesh.grad_rows_per_block(layout)
        P = layout.ports
        with pytest.raises(ValueError, match="item 6c-3"):
            tmesh.apply_autograd(layout, torch.zeros(
                (1, *layout.phase_shape()), device="meta",
                requires_grad=True), torch.ones(P, device="meta"),
                torch.zeros((3, P), device="meta"))


def _records(layout, phases, transpose):
    rec = tmesh.trig_records(layout, phases, transpose)
    W = tmesh.lane_width(layout.ports)
    E = W // 2 + 1
    bits = rec.view(torch.int32)
    return (rec[..., :E * 64].reshape(*rec.shape[:2], E, 32, 2),
            bits[..., E * 64:E * 64 + 32], bits[..., E * 64 + 32])


def _level(v, e, ab, mode, first, last):
    """Route A's ``rows_level`` on v (S, B, 32, W) in place: records e
    (S, E, 32, 2), absent words ab (S, 32)."""
    W = v.shape[-1]
    H = W // 2
    partial = bool(mode & 2)

    def pair(j, i):
        c, s = e[:, i, :, 0][:, None], e[:, i, :, 1][:, None]
        a = ((((ab >> i) & 1) != 0) & partial)[:, None]
        lo, hi = v[..., j].clone(), v[..., j + 1].clone()
        v[..., j] = c * lo + s * torch.where(a, lo, hi)
        v[..., j + 1] = torch.where(a, c * hi + s * hi, c * hi - s * lo)

    if mode & 1 == 0:
        for i in range(H):
            pair(2 * i, i)
        return
    x0, xl = v[..., 0].clone(), v[..., W - 1].clone()
    left = torch.cat([xl[..., :1], xl[..., :-1]], -1)          # shfl_up
    right = torch.cat([x0[..., 1:], x0[..., -1:]], -1)         # shfl_down
    c, s = e[:, 0, :, 0][:, None], e[:, 0, :, 1][:, None]
    if partial:
        a0 = ((ab & 1) != 0)[:, None]
        v[..., 0] = torch.where(a0, c * x0 + s * x0, c * x0 - s * left)
    else:
        v[..., 0] = c * x0 - s * torch.where(first, -x0, left)
    for i in range(1, H):
        pair(2 * i - 1, i)
    c, s = e[:, H, :, 0][:, None], e[:, H, :, 1][:, None]
    self_ = ((((ab >> H) & 1) != 0)[:, None] if partial
             else last.expand(v.shape[0], 1, 32))
    v[..., W - 1] = c * xl + s * torch.where(self_, xl, right)


def _terms(v, g, parity):
    """``rows_terms``: each owned entry's g_lo·y_hi − g_hi·y_lo per row,
    (S, B, E, 32)."""
    S, B, _, W = v.shape
    H = W // 2
    out = torch.zeros((S, B, H + 1, 32))
    if parity == 0:
        for i in range(H):
            out[:, :, i] = g[..., 2 * i] * v[..., 2 * i + 1] \
                - g[..., 2 * i + 1] * v[..., 2 * i]
        return out
    for i in range(1, H):
        out[:, :, i] = g[..., 2 * i - 1] * v[..., 2 * i] \
            - g[..., 2 * i] * v[..., 2 * i - 1]
    yh = torch.cat([v[..., 1:, 0], v[..., -1:, 0]], -1)          # shfl_down
    gh = torch.cat([g[..., 1:, 0], g[..., -1:, 0]], -1)
    out[:, :, H] = g[..., W - 1] * yh - gh * v[..., W - 1]
    return out


def _route_a_grad_model(layout, phases, diag, y, dy, transpose, tile):
    """``mesh_rows_grad_kernel``'s arithmetic in plain torch, lanes as an
    axis, rows in blocks of ``tile`` whose sums add in column order:
    y, dy (S, B, P) → (dx (S, B, P), dphases (S, levels, slots))."""
    S, B, P = y.shape
    L, K = layout.levels, layout.slots
    W = tmesh.lane_width(P)
    ent, absent, modes = _records(layout, phases, not transpose)
    smap = torch.as_tensor(tmesh.grad_slot_map(layout)[:, :K].astype(np.int64))
    # the terms in the kernel's word order (word term_word(i, t) holds
    # entry i·32 + t)
    i, t = np.divmod(np.arange((W // 2 + 1) * 32), 32)
    order = torch.as_tensor(np.argsort(tmesh.term_word(W, i, t)))
    d = diag.expand(S, P) if diag.ndim == 1 else diag
    v = torch.zeros((S, B, 32 * W))
    g = torch.zeros((S, B, 32 * W))
    v[..., :P] = y / d[:, None] if transpose else y
    g[..., :P] = dy * d[:, None] if transpose else dy
    v, g = v.reshape(S, B, 32, W), g.reshape(S, B, 32, W)
    lane = torch.arange(32)
    first = lane == 0
    last = (lane == P // W - 1) & (P % W == 0)
    dph = torch.zeros((S, L, K))
    for cl in (range(L) if transpose else reversed(range(L))):
        mode = int(modes[0, cl])
        t = _terms(v, g, mode & 1).reshape(S, B, -1)[..., order]
        m = smap[cl]
        sign = torch.where(((m & tmesh.MAP_NEG) != 0) != transpose, -1.0, 1.0)
        e = torch.where(m >= 0, m & (tmesh.MAP_NEG - 1), 0)
        acc = torch.zeros((S, K))
        for r0 in range(0, B, tile):
            acc = acc + t[:, r0:r0 + tile].sum(1)[:, e]
        dph[:, cl] = torch.where(m >= 0, sign * acc, 0.0)
        _level(v, ent[:, cl], absent[:, cl], mode, first, last)
        _level(g, ent[:, cl], absent[:, cl], mode, first, last)
    g = g.reshape(S, B, 32 * W)[..., :P]
    return (g if transpose else g * d[:, None]), dph


# label -> (layout kind, ports, S, B, transpose, per-entry diag, tile)
GRAD_MODEL_CASES = {
    "rect139-tr": ("rect", 139, 2, 5, True, True, 2),
    "rect160": ("rect", 160, 2, 5, False, False, 4),
    "rect300-tr": ("rect", 300, 1, 4, True, True, 3),      # partial levels
    "rect1024": ("rect", 1024, 1, 3, False, True, 2),
    "reck40": ("reck", 40, 2, 3, False, True, 2),
    "reck60-tr": ("reck", 60, 2, 3, True, False, 1),
}


@pytest.mark.parametrize("label", sorted(GRAD_MODEL_CASES))
def test_route_a_grad_model_matches_plain(label, one_thread):
    """The warp-rows backward's lane algorithm against the plain version
    (which recovers each level's input and takes the phase term from it):
    dx bit for bit, dphases within the f32 bound, on rectangular layouts
    (full and partial levels, 32·W past the ports) and Reck ones, both
    transposes.  On one CPU thread (``one_thread``): the 1024-port trig
    tables are otherwise not the same bits from call to call."""
    kind, P, S, B, transpose, per_entry, tile = GRAD_MODEL_CASES[label]
    layout = _layout(kind, P)
    gen = torch.Generator().manual_seed(P + B)
    phases = torch.randn((S, *layout.phase_shape()), generator=gen)
    diag = torch.where(torch.rand((S, P), generator=gen) < 0.5, -1.0, 1.0)
    diag = diag if per_entry else diag[0]
    x = torch.randn((S, B, P), generator=gen)
    y = tph.mesh_apply_stacked(layout, phases, diag, x, transpose)
    dy = torch.randn(y.shape, generator=gen)
    dx, dph = _route_a_grad_model(layout, phases, diag, y, dy, transpose,
                                  tile)
    pdx, pdph = ref.mesh_apply_grad_ref(layout, phases, diag, x, y, dy,
                                        transpose)
    assert torch.equal(dx, pdx)
    scale = pdph.abs().max().item()
    assert (dph - pdph).abs().max().item() <= 1e-5 * scale + 1e-6


def test_route_a_grad_model_catches_a_wrong_sign():
    """The model is sharp: the slot map's sign bit dropped moves dphases
    off the plain version's."""
    layout = tph.rectangular_layout(139)
    gen = torch.Generator().manual_seed(0)
    phases = torch.randn((1, *layout.phase_shape()), generator=gen)
    diag = torch.ones(139)
    x = torch.randn((1, 3, 139), generator=gen)
    y = tph.mesh_apply_stacked(layout, phases, diag, x)
    dy = torch.randn(y.shape, generator=gen)
    smap = tmesh.grad_slot_map(layout)
    try:
        layout.__dict__["_grad_slot_map"] = np.where(
            smap >= 0, smap & (tmesh.MAP_NEG - 1), smap).astype(np.int32)
        _, dph = _route_a_grad_model(layout, phases, diag, y, dy, False, 3)
    finally:
        layout.__dict__["_grad_slot_map"] = smap
    _, pdph = ref.mesh_apply_grad_ref(layout, phases, diag, x, y, dy)
    assert (dph - pdph).abs().max().item() > 1e-2 * pdph.abs().max().item()
