"""The mesh backwards on the CPU: the plain versions of the two backward
kernels (``kernels.ref.mesh_apply_grad_ref`` and ``mesh_densify_grad_ref``)
against ``torch.autograd`` of the port's plain forwards and ``jax.vjp`` of
the JAX package's (``repro.core.photonic.mesh_apply_stacked``, and the
densification composed from it as ``PhotonicMatrix.to_dense_stacked``
does); the error of the states the resident backward recovers level by
level, at 137 levels; and the autograd Functions around the kernels
(``MeshApplyFn``, ``MeshDensifyFn``) with their launches stubbed, on
torch's ``meta`` device, which takes the card's branch of the dispatch.

Tolerances: ``1e-5·max|want| + 1e-6`` per output (the same f32 products
summed in other orders, the states recovered from the outputs; measured
≤ 7e-7 of max|want| against autograd, ≤ 3e-6 against JAX, whose sin and
cos are XLA's); the recovered states within ``4e-6·max|x|`` of the
forward's at 137 levels (measured 1.2e-6).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import photonic as jph
from repro_torch.core import photonic as ph
from repro_torch.kernels import mesh_apply as mesh
from repro_torch.kernels import ops, ref
from test_torch_pinn import share_cores  # noqa: F401 (autouse)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max() + 1e-6)


def _jit_vjp(f, *primals, cotangent):
    """``jax.vjp`` of f at ``primals`` against ``cotangent``, jitted whole
    (one XLA program: ~7x faster on the CPU than the scans op by op)."""
    return jax.jit(lambda *a: jax.vjp(f, *a[:-1])[1](a[-1]))(
        *map(jnp.asarray, primals), jnp.asarray(cotangent))


@pytest.fixture
def one_thread():
    """torch on one CPU thread while the test runs (see
    ``test_recovered_states_at_1024_levels``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _apply_inputs(ports, S, B, shared, seed):
    rng = np.random.RandomState(seed)
    layout = ph.rectangular_layout(ports)
    phases = rng.standard_normal((S, *layout.phase_shape())).astype(
        np.float32)
    diag = np.where(rng.rand(S, ports) < 0.5, -1.0, 1.0).astype(np.float32)
    x = rng.standard_normal((B, ports) if shared else (S, B, ports)).astype(
        np.float32)
    dy = rng.standard_normal((S, B, ports)).astype(np.float32)
    return layout, phases, diag, x, dy


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("ports,shared", [(4, False), (16, True), (64, False),
                                          (144, False), (144, True)])
def test_mesh_apply_grad_ref_matches_autograd_and_jax(ports, shared,
                                                      transpose):
    """dx and dphases of the mesh backwards' plain version (recovering
    every level's input from y) against autograd of the gather form and
    ``jax.vjp`` of the JAX package's, at the resident backward's widths
    and at 144 ports, the warp-rows backward's; a shared x's gradient sums
    over the stack."""
    layout, phases, diag, x, dy = _apply_inputs(ports, 3, 7, shared,
                                                ports + transpose)
    tp = torch.tensor(phases, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y = ph.mesh_apply_stacked(layout, tp, torch.tensor(diag), tx, transpose)
    want_x, want_p = torch.autograd.grad(y, (tx, tp), torch.tensor(dy))
    dx, dph = ref.mesh_apply_grad_ref(layout, tp.detach(),
                                      torch.tensor(diag), tx.detach(),
                                      y.detach(), torch.tensor(dy), transpose)
    assert dx.shape == tx.shape and dph.shape == tp.shape
    _close(dx, want_x)
    _close(dph, want_p)
    jl = jph.rectangular_layout(ports)
    jp, jx = _jit_vjp(lambda p, xx: jph.mesh_apply_stacked(
        jl, p, jnp.asarray(diag), xx, transpose), phases, x, cotangent=dy)
    _close(dx, jx)
    _close(dph, jp)


def _densify_inputs(noisy, S=2, seed=0):
    """The paper's two core matrix shapes (4 x 16 and 16 x 4; meshes of 4
    and 16 ports) and an 8 x 12, S stacked phase sets, ±1 diags (shared on
    one), the chip's noise, and the cores' upstream gradients, numpy."""
    rng = np.random.RandomState(seed)
    shapes = [(4, 16), (16, 4), (8, 12)]
    pms, ps, nzs, dws = [], [], [], []
    for g, (o, i) in enumerate(shapes):
        pm = ph.PhotonicMatrix(o, i)
        p = {"phases_u": rng.standard_normal(
                 (S, *pm.layout_u.phase_shape())),
             "phases_v": rng.standard_normal(
                 (S, *pm.layout_v.phase_shape())),
             "sigma": 0.5 + rng.rand(S, pm.k)}
        for key, n in (("diag_u", o), ("diag_v", i)):
            shape = (n,) if g == 1 else (S, n)
            p[key] = np.where(rng.rand(*shape) < 0.5, -1.0, 1.0)
        nz = {side: {"gamma": 1.0 + 0.002 * rng.standard_normal(
                         lay.phase_shape()),
                     "bias": 2 * np.pi * rng.rand(*lay.phase_shape())}
              for side, lay in (("u", pm.layout_u), ("v", pm.layout_v))}
        pms.append(pm)
        ps.append({k: v.astype(np.float32) for k, v in p.items()})
        nzs.append({s: {k: v.astype(np.float32) for k, v in d.items()}
                    for s, d in nz.items()} if noisy else None)
        dws.append(rng.standard_normal((S, o, i)).astype(np.float32))
    return pms, ps, nzs, dws


def _jax_densify(pm, p, nz, model):
    """``PhotonicMatrix.to_dense_stacked``'s arithmetic from the JAX
    package's jnp mesh (``mesh_apply_stacked``), of (phases_u, phases_v,
    sigma)."""
    lu, lv = jph.rectangular_layout(pm.out_dim), jph.rectangular_layout(
        pm.in_dim)

    def f(pu, pv, sig):
        if nz is not None:
            pu = model.effective_phases(pu, nz["u"])
            pv = model.effective_phases(pv, nz["v"])
        eye = jnp.eye(pm.in_dim, dtype=jnp.float32)
        z = jph.mesh_apply_stacked(lv, pv, jnp.asarray(p["diag_v"]), eye,
                                   transpose=True)
        z = z[..., :pm.k] * sig[:, None, :]
        z = jnp.pad(z, [(0, 0), (0, 0), (0, pm.out_dim - pm.k)])
        y = jph.mesh_apply_stacked(lu, pu, jnp.asarray(p["diag_u"]), z)
        return jnp.swapaxes(y, -1, -2)
    return f


@pytest.mark.parametrize("saved", [True, False])
@pytest.mark.parametrize("noisy", [False, True])
def test_mesh_densify_grad_ref_matches_autograd_and_jax(noisy, saved):
    """dphases_u, dphases_v (of the commanded phases, through the noise
    model's transpose) and dsigma of the grouped backward's plain version,
    keeping the forward states or recovering them, against autograd of
    ``photonic.mesh_densify_stacked``, and the kept states' (the kernel's
    choice at these shapes) against ``jax.vjp`` of the JAX package's
    densification."""
    pms, ps, nzs, dws = _densify_inputs(noisy, seed=int(noisy))
    model = ph.NoiseModel(enabled=noisy)
    tp = [{k: torch.tensor(v, requires_grad=k not in
                           ph.PHOTONIC_BUFFER_KEYS) for k, v in p.items()}
          for p in ps]
    tnz = [None if nz is None else {s: {k: torch.tensor(v)
                                        for k, v in d.items()}
                                    for s, d in nz.items()} for nz in nzs]
    W = ph.mesh_densify_stacked(pms, tp, tnz, model)
    leaves = [p[k] for p in tp for k in ("phases_u", "phases_v", "sigma")]
    want = torch.autograd.grad(W, leaves, [torch.tensor(d) for d in dws])
    got = ref.mesh_densify_grad_ref(
        pms, [{k: v.detach() for k, v in p.items()} for p in tp], tnz, model,
        [torch.tensor(d) for d in dws], saved)
    jmodel = jph.NoiseModel(enabled=noisy)
    for g, (pm, p, nz, dw) in enumerate(zip(pms, ps, nzs, dws)):
        for a, b in zip(got[g], want[3 * g:3 * g + 3]):
            assert a.shape == b.shape
            _close(a, b)
        if not saved:
            continue
        jnz = None if nz is None else jax.tree.map(jnp.asarray, nz)
        for a, b in zip(got[g], _jit_vjp(
                _jax_densify(pm, p, jnz, jmodel), p["phases_u"],
                p["phases_v"], p["sigma"], cotangent=dw)):
            _close(a, b)


def _warp_tree(t, ports):
    """The warp design's sum over the rows of ``t`` ``(S, rows, n)``: row
    r of warp q is row q·R + r, R = 32 // ports rows a warp; a warp's rows
    combine by its shuffle tree (rows r and r + d, d = 1, 2, 4, ...), then
    the warps' sums add in warp order (``warp_sum``)."""
    S, rows, n = t.shape
    R = 32 // ports
    warps = -(-rows // R)
    t = torch.nn.functional.pad(t, (0, 0, 0, warps * R - rows)).reshape(
        S, warps, R, n).clone()
    d = 1
    while d < R:
        for r in range(0, R - d, 2 * d):
            t[:, :, r] = t[:, :, r] + t[:, :, r + d]
        d *= 2
    acc = t[:, 0, 0]
    for q in range(1, warps):
        acc = acc + t[:, q, 0]
    return acc


def _warp_walk(layout, phases, x, transpose, g=None, states=None):
    """One mesh of the warp design, rows ``(S, rows, P)`` in lanes: the
    forward levels (each level's input appended to ``states``), or with
    ``g`` the reverse walk from the kept ``states``: a slot's term over a
    row formed at its first wire (sign −1) from both wires' x and g, the
    rows summed by ``_warp_tree``.  Returns the output, or (g at the
    input, dphases)."""
    P, L, K = layout.ports, layout.levels, layout.slots
    plan = ph.mesh_plan_tensors(layout, phases.device)
    perm, sign, slot = plan["perm"], plan["sign"], plan["slot"]
    ph_w = torch.gather(phases, -1, slot.expand(*phases.shape[:-1], P))
    C = torch.where(sign != 0.0, torch.cos(ph_w), torch.ones_like(ph_w))
    Sn = sign * torch.sin(ph_w)                      # stored level order
    if g is None:
        for c in range(L):
            cl = L - 1 - c if transpose else c
            s = -Sn[:, cl, None] if transpose else Sn[:, cl, None]
            states.append(x)
            x = C[:, cl, None] * x + s * x[..., perm[cl]]
        return x
    dph = torch.zeros((phases.shape[0], L, K))
    for c in reversed(range(L)):
        cl = L - 1 - c if transpose else c
        x = states[c]
        xp, gp = x[..., perm[cl]], g[..., perm[cl]]
        cc, sc = C[:, cl, None], Sn[:, cl, None]
        cb = cc if transpose else -cc
        first = torch.nonzero(sign[cl] < 0.0)[:, 0]
        term = (g * (sc * x + cb * xp) + gp * (sc * xp - cb * x))[..., first]
        dph[:, cl, slot[cl, first]] = _warp_tree(term, P)
        g = cc * g - (-sc if transpose else sc) * gp
    return g, dph


def _warp_grad_model(pms, params, noises, model, dW):
    """The grouped backward's warp design (``csrc/mesh_apply.cu::
    mesh_densify_grad_warp_kernel``) in its summation order on the host:
    the walks of ``ref.mesh_densify_grad_ref`` with every state kept, each
    slot's phase gradient summed over a warp's rows by its shuffle tree
    and over the warps in order, dσ over the rows in order.  Returns
    ``[(dphases_u, dphases_v, dsigma)]`` per matrix."""
    out = []
    for pm, p, nz, dw in zip(pms, params, noises, dW):
        noisy = model.enabled and nz is not None
        pu, pv = p["phases_u"], p["phases_v"]
        if noisy:
            pu = model.effective_phases(pu, nz["u"])
            pv = model.effective_phases(pv, nz["v"])
        S, k, n = pu.shape[0], pm.k, pm.in_dim
        dv = p["diag_v"][..., None, :k] if p["diag_v"].ndim == 2 \
            else p["diag_v"][:k]
        du = p["diag_u"][..., None, :] if p["diag_u"].ndim == 2 \
            else p["diag_u"]
        sig = p["sigma"][:, None, :]
        sv, su = [], []
        a = _warp_walk(pm.layout_v, pv, torch.eye(n).expand(S, -1, -1),
                       True, states=sv)
        z = torch.nn.functional.pad(a[..., :k] * dv * sig,
                                    (0, pm.out_dim - k)) * du
        _warp_walk(pm.layout_u, pu, z, False, states=su)
        g, dph_u = _warp_walk(pm.layout_u, pu, None, False,
                              dw.transpose(-1, -2), su)
        gz = g[..., :k] * du[..., :k]
        dsig = torch.zeros((S, k))
        for j in range(n):
            dsig = dsig + (a[:, j, :k] * dv[..., 0, :] if dv.ndim == 3
                           else a[:, j, :k] * dv) * gz[:, j]
        da = torch.nn.functional.pad(gz * sig * dv, (0, n - k))
        _, dph_v = _warp_walk(pm.layout_v, pv, None, True, da, sv)
        if noisy:
            dph_u = ref._noise_transpose(model, nz["u"], dph_u)
            dph_v = ref._noise_transpose(model, nz["v"], dph_v)
        out.append((dph_u, dph_v, dsig))
    return out


@pytest.mark.parametrize("noisy", [False, True])
def test_warp_design_summation_order_matches_plain_and_jax(noisy):
    """The grouped backward's warp design, in its own summation order
    (``_warp_grad_model``: lanes of a warp's rows, its shuffle tree, the
    warps in order), against ``ref.mesh_densify_grad_ref`` with the
    states kept and ``jax.vjp`` of the JAX package's densification, noise
    on and off, on the paper's two core shapes and an 8 x 12 (12-port
    rows in 6 warps of 2, 8-port ones in warps of 4)."""
    pms, ps, nzs, dws = _densify_inputs(noisy, seed=5 + int(noisy))
    assert mesh.densify_grad_design(pms) == "warp"
    model = ph.NoiseModel(enabled=noisy)
    tp = [{k: torch.tensor(v) for k, v in p.items()} for p in ps]
    tnz = [None if nz is None else {s: {k: torch.tensor(v)
                                        for k, v in d.items()}
                                    for s, d in nz.items()} for nz in nzs]
    tdw = [torch.tensor(d) for d in dws]
    got = _warp_grad_model(pms, tp, tnz, model, tdw)
    want = ref.mesh_densify_grad_ref(pms, tp, tnz, model, tdw, True)
    jmodel = jph.NoiseModel(enabled=noisy)
    for g, (pm, p, nz, dw) in enumerate(zip(pms, ps, nzs, dws)):
        jnz = None if nz is None else jax.tree.map(jnp.asarray, nz)
        jax_grads = _jit_vjp(_jax_densify(pm, p, jnz, jmodel),
                             p["phases_u"], p["phases_v"], p["sigma"],
                             cotangent=dw)
        for a, b, c in zip(got[g], want[g], jax_grads):
            assert a.shape == b.shape
            _close(a, b)
            _close(a, c)


def _res_warp_model(layout, phases, diag, y, dy, transpose, config,
                    drop=None):
    """The resident backward's warp design (``csrc/mesh_apply.cu::
    mesh_apply_grad_warp_kernel``) in its summation order on the host: the
    levels walked back from y as ``ref.mesh_reverse`` walks them (each
    slot's term over a row formed at its first wire), the terms of a row
    group's R rows summed by the warp's shuffle tree, the groups a warp
    walks added in order, the warps of a column in order, the columns in
    order; ``config`` is ``mesh_apply.resident_grad_warp_config``'s.
    ``drop``: a row group left out (a mutant).  Returns (dx, dphases)."""
    _, R, warps, cols, per, _, _ = config
    P, L, K = layout.ports, layout.levels, layout.slots
    S, B = y.shape[:2]
    d = diag[:, None, :] if diag.ndim == 2 else diag
    y, g = (y / d, dy * d) if transpose else (y, dy)
    plan = ph.mesh_plan_tensors(layout, y.device)
    perm, sign, slot = plan["perm"], plan["sign"], plan["slot"]
    ph_w = torch.gather(phases, -1, slot.expand(S, L, P))
    C = torch.where(sign != 0.0, torch.cos(ph_w), torch.ones_like(ph_w))
    Sn = sign * torch.sin(ph_w)                      # stored level order
    groups = -(-B // R)
    terms = torch.zeros((S, groups, L, K))
    for c in reversed(range(L)):
        cl = L - 1 - c if transpose else c
        cc, sc = C[:, cl, None], Sn[:, cl, None]
        s = -sc if transpose else sc
        yp, gp = y[..., perm[cl]], g[..., perm[cl]]
        x = cc * y - s * yp
        first = torch.nonzero(sign[cl] < 0.0)[:, 0]
        cb = cc if transpose else -cc
        xp = x[..., perm[cl]]
        t = (g * (sc * x + cb * xp) + gp * (sc * xp - cb * x))[..., first]
        rows = torch.nn.functional.pad(t, (0, 0, 0, groups * R - B))
        rows = rows.reshape(S, groups, R, -1).clone()
        step = 1
        while step < R:                               # the shuffle tree
            for r in range(0, R - step, 2 * step):
                rows[:, :, r] = rows[:, :, r] + rows[:, :, r + step]
            step *= 2
        terms[:, :, cl, slot[cl, first]] = rows[:, :, 0]
        g = cc * g - s * gp
        y = x
    dph = None
    for col in range(cols):
        block = None
        for q in range(warps):
            acc = torch.zeros((S, L, K))
            for gi in range(col * per + q, min(groups, (col + 1) * per),
                            warps):
                if gi != drop:
                    acc = acc + terms[:, gi]
            block = acc if block is None else block + acc
        dph = block if dph is None else dph + block
    return (g if transpose else g * d), dph


@pytest.mark.parametrize("ports,S,shared,transpose,sms", [
    (16, 1, False, False, 4), (16, 2, False, True, 2),
    (21, 1, True, True, 1), (21, 2, True, True, 8),
    (64, 1, False, False, 2), (64, 2, False, True, 1)])
def test_resident_warp_design_summation_order_matches_plain_and_jax(
        ports, S, shared, transpose, sms):
    """The resident backward's warp design in its own summation order
    (``_res_warp_model``: a warp's rows by its shuffle tree, its row
    groups, the warps and the block columns in order; 16 and 21 ports a
    wire a lane, 64 two), with the launch ``resident_grad_warp_config``
    gives a card of ``sms`` SMs (one column to several, folded or
    summed), against ``ref.mesh_apply_grad_ref`` and ``jax.vjp`` of the
    JAX package's mesh: dx bit for bit with the plain version, dphases
    within the tolerance; the model with a row group dropped fails it."""
    B = {16: 75, 21: 41, 64: 19}[ports]
    layout, phases, diag, x, dy = _apply_inputs(ports, S, B, shared,
                                                ports + S + 7 * transpose)
    assert mesh.resident_grad_design(layout) == "warp"
    config = mesh.resident_grad_warp_config(layout, S, B, sms)
    assert config[0] == (ports > 32) and config[1] == (1 if ports > 32
                                                       else 32 // ports)
    tp, td, tdy = map(torch.tensor, (phases, diag, dy))
    y = ph.mesh_apply_stacked(layout, tp, td, torch.tensor(x), transpose)
    dx, dph = _res_warp_model(layout, tp, td, y, tdy, transpose, config)
    want_x, want_p = ref.mesh_apply_grad_ref(layout, tp, td, torch.tensor(x),
                                             y, tdy, transpose)
    assert torch.equal(dx.sum(0) if shared else dx, want_x)
    _close(dph, want_p)
    jp, jx = _jit_vjp(lambda p, xx: jph.mesh_apply_stacked(
        jph.rectangular_layout(ports), p, jnp.asarray(diag), xx, transpose),
        phases, x, cotangent=dy)
    _close(dx.sum(0) if shared else dx, jx)
    _close(dph, jp)
    groups = -(-B // config[1])
    _, mutant = _res_warp_model(layout, tp, td, y, tdy, transpose, config,
                                drop=groups // 2)
    with pytest.raises(AssertionError):
        _close(mutant, want_p)


def test_resident_grad_design_and_launch_config():
    """The resident backward's design from the layout: rectangular meshes
    of 4 to 64 ports take ``"warp"`` (a wire a lane up to 32, two past
    it), a 65- and a 137-port one ``"block"``; a layout of at most 32
    ports whose pairs are not adjacent ``"warp"``, one of 33 to 64
    ``"block"``; a forced ``"warp"`` raises where it does not take the
    layout.  The launch at onn's shapes on an H100's 132 SMs: layer 0's V
    mesh on 100 rows in one launch that folds its columns; the hidden
    layer's 64-port mesh on 4300 rows spread over one block an SM."""
    for ports in (4, 5, 16, 21, 32, 33, 48, 63, 64):
        assert mesh.resident_grad_design(ph.rectangular_layout(ports)) == \
            "warp"
    for ports in (65, 137):
        layout = ph.rectangular_layout(ports)
        assert mesh.grad_fits(layout)
        assert mesh.resident_grad_design(layout) == "block"
        assert mesh.resident_grad_design(layout, "block") == "block"
        with pytest.raises(ValueError, match="no 'warp' design"):
            mesh.resident_grad_design(layout, "warp")
    far = [(a, (a + 5) % 24) for a in range(0, 24, 2)]
    assert not mesh.adjacent_pairs(ph.schedule_ops(24, far))
    assert mesh.resident_grad_design(ph.schedule_ops(24, far)) == "warp"
    far = [(a, (a + 5) % 40) for a in range(0, 40, 2)]
    assert not mesh.adjacent_pairs(ph.schedule_ops(40, far))
    assert mesh.resident_grad_design(ph.schedule_ops(40, far)) == "block"
    with pytest.raises(ValueError, match="no 'fast' design"):
        mesh.resident_grad_design(ph.rectangular_layout(16), "fast")
    assert mesh.resident_grad_warp_config(ph.rectangular_layout(21), 1, 100,
                                          132) == (False, 1, 8, 13, 8, 1,
                                                   True)
    pairs, R, warps, cols, per, chunk, fold = mesh.resident_grad_warp_config(
        ph.rectangular_layout(64), 1, 4300, 132)
    assert (pairs, R, fold) == (True, 1, False)
    assert chunk * warps >= per and chunk == 2
    assert cols <= mesh.RES_WARP_BLOCKS_PER_SM * 132
    assert (cols - 1) * per < 4300 <= cols * per
    for ports, B in ((16, 4300), (21, 100), (21, 4300), (64, 4300)):
        layout = ph.rectangular_layout(ports)
        warps = mesh.resident_grad_warp_config(layout, 1, B, 132)[2]
        assert mesh.resident_grad_warp_smem_bytes(
            layout, warps) <= mesh.SMEM_MAX_BYTES


def test_forced_resident_design_is_scoped_and_checked():
    """``_forced_resident`` forces a resident design only inside its
    block, restores the one before it (nested too), and refuses a design
    the resident backward does not have."""
    assert mesh._RESIDENT_FORCED is None
    with mesh._forced_resident("block"):
        assert mesh._RESIDENT_FORCED == "block"
        with mesh._forced_resident("warp"):
            assert mesh._RESIDENT_FORCED == "warp"
        assert mesh._RESIDENT_FORCED == "block"
    assert mesh._RESIDENT_FORCED is None
    with pytest.raises(ValueError, match="no resident design 'fast'"):
        with mesh._forced_resident("fast"):
            pass
    with pytest.raises(KeyError), mesh._forced_resident("warp"):
        raise KeyError
    assert mesh._RESIDENT_FORCED is None


def test_fold_tickets_are_per_stream_zero_and_grow():
    """The warp design's fold tickets: zero, at least S, cached for a
    (device, stream) and anew for a larger stack; two streams of one
    device never share a buffer, so a fold's reset is ordered by its own
    stream."""
    dev = torch.device("cpu")
    for key in [(dev, 11), (dev, 12)]:
        mesh._TICKETS.pop(key, None)
    a = mesh._tickets(dev, 11, 3)
    assert a.dtype == torch.int32 and a.numel() >= 3 and not a.any()
    assert mesh._tickets(dev, 11, 2) is a
    b = mesh._tickets(dev, 12, 3)
    assert b is not a and b.data_ptr() != a.data_ptr()
    c = mesh._tickets(dev, 11, a.numel() + 1)
    assert c is not a and c.numel() > a.numel() and not c.any()
    assert mesh._tickets(dev, 11, 1) is c and mesh._tickets(dev, 12, 1) is b
    for key in [(dev, 11), (dev, 12)]:
        mesh._TICKETS.pop(key, None)


def _bytes(grp) -> bytes:
    return ctypes.string_at(ctypes.addressof(grp), ctypes.sizeof(grp))


def _fresh(kind, pms, ps, nzs, model, out):
    """``pack_group``'s descriptors, with the backward's saved-state flags
    set as its template sets them."""
    grp = mesh.pack_group(pms, ps, nzs, model, None, out)
    if kind == "backward":
        for g, pm in enumerate(pms):
            grp.m[g].save_states = int(mesh.densify_grad_saves(pm))
    return grp


def _bound(kind, pms, ps, nzs, model, dW):
    """(template, descriptors, outputs) of one call of ``kind``."""
    tensors = [p[k] for p in ps for k in mesh.PARAM_KEYS]
    if kind == "backward":
        tensors += dW
    tpl = mesh.group_template(kind, pms, ps, nzs, model, None, tensors, dW)
    flat = torch.empty(tpl.size)
    grp = tpl.bind(tensors, flat.data_ptr())
    return tpl, grp, (tpl.outputs(flat) if kind == "forward" else dW)


@pytest.mark.parametrize("kind", ["forward", "backward"])
def test_group_template_packs_what_pack_group_packs(kind):
    """The template of the paper's 8 core matrices, bound to a call's
    tensors, holds the same bytes as a fresh ``pack_group`` of them; with
    every param tensor (and dW) swapped for a new one the same template
    serves the next call, whose bytes are a fresh pack of the new tensors
    (no stale pointer); new noise tensors or another stack size make a new
    template; at most ``TEMPLATES_KEPT`` stay on the first matrix."""
    cpu = torch.device("cpu")
    pms, ps, nzs, model, _ = chip_smoke.densify_inputs(1024, 4, 1, True,
                                                       None, cpu, 7)
    dW = [torch.randn((1, pm.out_dim, pm.in_dim)) for pm in pms]
    tpl, grp, out = _bound(kind, pms, ps, nzs, model, dW)
    first = _bytes(grp)
    assert first == _bytes(_fresh(kind, pms, ps, nzs, model, out))
    if kind == "backward":
        assert (tpl.design, tpl.warps) == ("warp", 8)
        # each matrix's gradients start after the sizes of those before
        sizes = [pm.layout_u.levels * pm.layout_u.slots
                 + pm.layout_v.levels * pm.layout_v.slots + pm.k
                 for pm in pms]
        assert list(tpl.offsets.grads[:8]) == np.cumsum([0] + sizes[:-1]
                                                        ).tolist()
    ps2 = [{k: v.clone() for k, v in p.items()} for p in ps]
    dW2 = [d.clone() for d in dW]
    tpl2, grp2, out2 = _bound(kind, pms, ps2, nzs, model, dW2)
    assert tpl2 is tpl and _bytes(grp2) != first
    assert _bytes(grp2) == _bytes(_fresh(kind, pms, ps2, nzs, model, out2))
    nzs2 = [{s: {k: t.clone() for k, t in d.items()} for s, d in nz.items()}
            for nz in nzs]
    tpl3, grp3, out3 = _bound(kind, pms, ps2, nzs2, model, dW2)
    assert tpl3 is not tpl
    assert _bytes(grp3) == _bytes(_fresh(kind, pms, ps2, nzs2, model, out3))
    ps3 = [{k: torch.cat([v, v]) for k, v in p.items()} for p in ps2]
    dW3 = [torch.cat([d, d]) for d in dW2]
    tpl4, grp4, out4 = _bound(kind, pms, ps3, nzs2, model, dW3)
    assert tpl4 is not tpl3 and tpl4.grp.stack == 2
    assert _bytes(grp4) == _bytes(_fresh(kind, pms, ps3, nzs2, model, out4))
    for _ in range(mesh.TEMPLATES_KEPT + 2):
        fresh_nz = [{s: {k: t.clone() for k, t in d.items()}
                     for s, d in nz.items()} for nz in nzs]
        _bound(kind, pms, ps, fresh_nz, model, dW)
    assert len(pms[0].__dict__["_group_templates"]) == mesh.TEMPLATES_KEPT


def test_group_template_refuses_what_does_not_fit():
    """A call whose tensor no longer fits its template — another shape, a
    float64, a strided one — repacks, and the pack raises naming the
    tensor; the call after it with the right tensors binds as before.  The
    design the backward picks: warp for the paper's matrices, block for
    tt_L 2's 32 x 64 and 64 x 32."""
    cpu = torch.device("cpu")
    pms, ps, nzs, model, _ = chip_smoke.densify_inputs(1024, 4, 1, True,
                                                       None, cpu, 8)
    dW = [torch.randn((1, pm.out_dim, pm.in_dim)) for pm in pms]
    tpl, _, _ = _bound("backward", pms, ps, nzs, model, dW)
    bad = [dict(ps[0], phases_v=ps[0]["phases_v"][:, :-1].contiguous()),
           dict(ps[0], sigma=ps[0]["sigma"].double()),
           dict(ps[0], phases_u=ps[0]["phases_u"].transpose(1, 2)
                .contiguous().transpose(1, 2))]
    for b, match in zip(bad, ("matrix 0 v phases", "matrix 0 sigma",
                              "contiguous")):
        assert not tpl.fits([b[k] for k in mesh.PARAM_KEYS]
                            + [p[k] for p in ps[1:] for k in mesh.PARAM_KEYS]
                            + dW)
        with pytest.raises(ValueError, match=match):
            _bound("backward", pms, [b, *ps[1:]], nzs, model, dW)
    with pytest.raises(ValueError, match="out"):
        _bound("backward", pms, ps, nzs, model, [dW[0].double(), *dW[1:]])
    assert _bound("backward", pms, ps, nzs, model, dW)[0] is not None
    assert mesh.densify_grad_design(pms) == "warp"
    assert mesh.densify_grad_warps(pms) == 8
    wide, *_ = chip_smoke.densify_inputs(1024, 2, 1, False, None, cpu, 9)
    assert {(pm.out_dim, pm.in_dim) for pm in wide} == {(32, 64), (64, 32)}
    assert mesh.densify_grad_design(wide) == "block"
    with pytest.raises(ValueError, match="CUDA"):
        mesh.mesh_densify_grad(pms, ps, nzs, model, dW)


def test_recovered_states_at_137_levels():
    """The resident backward recovers each level's input from its output;
    on a 137-port rectangular mesh (137 levels, the widest the resident
    design holds) every recovered state stays within 4e-6 of max|x| of the
    forward's (measured 1.2e-6), and the gradients within the f32 bound of
    autograd's, which uses the forward's states."""
    layout = ph.rectangular_layout(137)
    assert mesh.grad_fits(layout) and mesh.mesh_design(layout) == "resident"
    assert not mesh.grad_fits(ph.rectangular_layout(139))
    gen = torch.Generator().manual_seed(137)
    phases = 3 * torch.randn((1, *layout.phase_shape()), generator=gen)
    x = torch.randn((1, 64, 137), generator=gen)
    states = []
    y = ref.mesh_levels(layout, phases, x, False, states)
    cos, sin = ph.mesh_gather_tables(layout, phases)
    perm = ph.mesh_plan_tensors(layout, x.device)["perm"]
    worst = 0.0
    for c in reversed(range(layout.levels)):
        y = cos[..., c, None, :] * y - sin[..., c, None, :] * y[..., perm[c]]
        worst = max(worst, ((y - states[c]).abs().max()
                            / states[c].abs().max()).item())
    assert 0.0 < worst <= 4e-6
    tp = phases.clone().requires_grad_()
    tx = x.clone().requires_grad_()
    out = ph.mesh_apply_stacked(layout, tp, torch.ones(137), tx)
    dy = torch.randn(out.shape, generator=gen)
    want = torch.autograd.grad(out, (tx, tp), dy)
    got = ref.mesh_apply_grad_ref(layout, phases, torch.ones(137), x,
                                  out.detach(), dy)
    for a, b in zip(got, want):
        _close(a, b)


def test_recovered_states_at_1024_levels(one_thread):
    """The warp-rows backward recovers each level's input from its output
    too; on onn's 1024-port rectangular mesh (1024 levels) every state
    recovered from the output of 3 rows stays within 2e-5 of max|x| of
    the forward's (measured 3.7e-6, 3.7 times the 137-level mesh's), and
    ``mesh_reverse``'s gradients from recovered states agree with those
    from the kept ones within the f32 bound.  One CPU thread: the trig
    tables of a 1024-port mesh (a million elements) are computed in
    parallel chunks, and where the thread count moves a chunk's edge an
    element's sin or cos comes from torch's vector or scalar path, one
    ulp apart; the recovery then undoes a slightly other rotation than
    the forward applied (1.8e-3 of max|x| measured so)."""
    layout = ph.rectangular_layout(1024)
    gen = torch.Generator().manual_seed(1024)
    phases = 3 * torch.randn((1, *layout.phase_shape()), generator=gen)
    x = torch.randn((1, 3, 1024), generator=gen)
    states = []
    out = ref.mesh_levels(layout, phases, x, False, states)
    cos, sin = ph.mesh_gather_tables(layout, phases)
    perm = ph.mesh_plan_tensors(layout, x.device)["perm"]
    y, worst = out, 0.0
    for c in reversed(range(layout.levels)):
        y = cos[..., c, None, :] * y - sin[..., c, None, :] * y[..., perm[c]]
        worst = max(worst, ((y - states[c]).abs().max()
                            / states[c].abs().max()).item())
    assert 0.0 < worst <= 2e-5
    dy = torch.randn(out.shape, generator=gen)
    for a, b in zip(ref.mesh_reverse(layout, phases, out, dy),
                    ref.mesh_reverse(layout, phases, out, dy, False, states)):
        _close(a, b)


def test_grad_layouts_and_shared_memory():
    """The resident backward holds what the forward's resident design
    holds up to 138 ports (four row buffers instead of two), at least one
    row a block and the block columns' scratch bounded by the grid, not
    the rows; the grouped backward keeps every paper core matrix's states
    (17 KB at most)."""
    from repro_torch.core import tt
    for ports in (4, 16, 21, 64, 137, 138):
        layout = ph.rectangular_layout(ports)
        assert mesh.grad_fits(layout)
        rows = mesh.grad_rows_per_block(layout)
        assert rows >= 1 and mesh.grad_smem_bytes(
            ports, ports, rows) <= mesh.SMEM_MAX_BYTES
    assert mesh.grad_rows_per_block(ph.rectangular_layout(16)) == 64
    assert mesh.grad_columns(11, 68, 132) == 48
    assert mesh.grad_columns(1, 3, 132) == 3
    for ports in (140, 1040):       # the warp-rows backward's; none's
        with pytest.raises(ValueError, match="item 6c-3"):
            mesh.grad_rows_per_block(ph.rectangular_layout(ports))
    for r, m, n, rn in tt.PAPER_TONN_SPEC.core_shapes:
        pm = ph.PhotonicMatrix(r * m, n * rn)
        assert mesh.densify_grad_saves(pm)
        states = mesh.densify_grad_smem_bytes(pm, True) - \
            mesh.densify_grad_smem_bytes(pm, False)
        assert states <= 17 * 1024
    assert not mesh.densify_grad_saves(ph.PhotonicMatrix(64, 64))


# ------------------------------------------- the Functions, launches stubbed

@pytest.fixture
def stub_launches(monkeypatch):
    """Each kernel wrapper replaced by a stand-in that records its call and
    returns ``meta`` tensors of the kernel's output shapes."""
    calls = []

    def apply(layout, phases, diag, x, transpose=False):
        calls.append("mesh_apply_stacked")
        S, B = phases.shape[0], x.shape[-2]
        return torch.empty((S, B, layout.ports), device=x.device)

    def apply_grad(layout, phases, diag, y, dy, transpose=False,
                   need_dx=True, need_dphases=True):
        calls.append(("mesh_apply_stacked_grad", need_dx, need_dphases)
                     + (() if mesh.grad_fits(layout)
                        else (mesh.grad_design(layout),)))
        return (torch.empty_like(y) if need_dx else None,
                torch.empty_like(phases) if need_dphases else None)

    def densify(matrices, params, noises, noise_model=None, quant=None):
        calls.append("mesh_densify_stacked")
        S = params[0]["sigma"].shape[0]
        return [torch.empty((S, pm.out_dim, pm.in_dim), device="meta")
                for pm in matrices]

    def densify_grad(matrices, params, noises, noise_model, dW):
        calls.append("mesh_densify_grad")
        assert all(d.is_contiguous() for d in dW)
        return [(torch.empty_like(p["phases_u"]),
                 torch.empty_like(p["phases_v"]),
                 torch.empty_like(p["sigma"])) for p in params]

    monkeypatch.setattr(mesh, "mesh_apply_stacked", apply)
    monkeypatch.setattr(mesh, "mesh_apply_stacked_grad", apply_grad)
    monkeypatch.setattr(mesh, "mesh_densify_stacked", densify)
    monkeypatch.setattr(mesh, "mesh_densify_grad", densify_grad)
    return calls


def test_mesh_apply_fn_reaches_the_warp_rows_backward(stub_launches):
    """Under grad onn's 1024-port mesh goes through ``MeshApplyFn`` too:
    the forward launch (route A or B by the rows) and one backward launch,
    whose design from the layout is ``warp_rows``; a layout no backward
    holds raises before any launch, naming item 6c-3."""
    layout = ph.rectangular_layout(1024)
    phases = torch.zeros((1, *layout.phase_shape()), device="meta",
                         requires_grad=True)
    diag = torch.ones(1024, device="meta")
    x = torch.zeros((1, 100, 1024), device="meta", requires_grad=True)
    y = ops.mesh_apply_stacked(layout, phases, diag, x, True)
    assert type(y.grad_fn).__name__ == "MeshApplyFnBackward"
    gp, gx = torch.autograd.grad(y, [phases, x], torch.ones_like(y))
    assert gp.shape == phases.shape and gx.shape == x.shape
    assert stub_launches == ["mesh_apply_stacked",
                             ("mesh_apply_stacked_grad", True, True,
                              "warp_rows")]
    wide = ph.rectangular_layout(1040)
    with pytest.raises(ValueError, match="item 6c-3"):
        ops.mesh_apply_stacked(wide, torch.zeros(
            (1, *wide.phase_shape()), device="meta", requires_grad=True),
            torch.ones(1040, device="meta"), torch.zeros((3, 1040),
                                                         device="meta"))
    assert len(stub_launches) == 2


@pytest.mark.parametrize("shared", [False, True])
def test_mesh_apply_fn_backward_asks_what_autograd_needs(stub_launches,
                                                         shared):
    """Under grad a resident layout goes through ``MeshApplyFn``: one
    forward launch, and one backward launch asking for dx only where x
    needs a gradient; a shared x's gradient comes back (B, P)."""
    layout = ph.rectangular_layout(16)
    phases = torch.zeros((3, *layout.phase_shape()), device="meta",
                         requires_grad=True)
    diag = torch.ones(16, device="meta")
    for x_grad in (False, True):
        x = torch.zeros((5, 16) if shared else (3, 5, 16), device="meta",
                        requires_grad=x_grad)
        y = ops.mesh_apply_stacked(layout, phases, diag, x)
        assert type(y.grad_fn).__name__ == "MeshApplyFnBackward"
        gp, *gx = torch.autograd.grad(
            y, [phases, x] if x_grad else [phases], torch.ones_like(y))
        assert gp.shape == phases.shape
        assert [g.shape for g in gx] == ([x.shape] if x_grad else [])
    assert stub_launches == ["mesh_apply_stacked",
                             ("mesh_apply_stacked_grad", False, True),
                             "mesh_apply_stacked",
                             ("mesh_apply_stacked_grad", True, True)]
    with torch.no_grad():
        assert ops.mesh_apply_stacked(layout, phases, diag, x).grad_fn is None


def test_mesh_densify_fn_backward_fills_what_needs_grad(stub_launches):
    """Under grad ``ops.mesh_densify_stacked`` goes through
    ``MeshDensifyFn``: one grouped forward and one grouped backward
    launch, gradients for the phases and sigma and none for the diag
    buffers; what it does not take raises before any launch: DAC-snapped
    phases (item 11), a diag buffer or a noise tensor that requires
    grad."""
    from repro_torch.kernels import quant as quant_lib
    pms = [ph.PhotonicMatrix(4, 16), ph.PhotonicMatrix(16, 4)]
    params = [{"phases_u": torch.zeros((2, *pm.layout_u.phase_shape()),
                                       device="meta", requires_grad=True),
               "phases_v": torch.zeros((2, *pm.layout_v.phase_shape()),
                                       device="meta", requires_grad=True),
               "sigma": torch.ones((2, pm.k), device="meta",
                                   requires_grad=True),
               "diag_u": torch.ones(pm.out_dim, device="meta"),
               "diag_v": torch.ones(pm.in_dim, device="meta")}
              for pm in pms]
    noises = [None, None]
    cores = ops.mesh_densify_stacked(pms, params, noises)
    assert all(type(c.grad_fn).__name__ == "MeshDensifyFnBackward"
               for c in cores)
    leaves = [p[k] for p in params for k in ("phases_u", "phases_v",
                                             "sigma")]
    grads = torch.autograd.grad(sum(c.sum() for c in cores), leaves)
    assert [g.shape for g in grads] == [t.shape for t in leaves]
    assert stub_launches == ["mesh_densify_stacked", "mesh_densify_grad"]
    pb8 = quant_lib.QuantConfig(enabled=True, dtype=None, phase_bits=8)
    with pytest.raises(ValueError, match="item 11"):
        ops.mesh_densify_stacked(pms, params, noises, quant=pb8)
    params[1]["diag_v"].requires_grad_()
    with pytest.raises(ValueError, match="diag buffer or a noise"):
        ops.mesh_densify_stacked(pms, params, noises)
    params[1]["diag_v"].requires_grad_(False)
    noisy = [None, {s: {"gamma": torch.ones(lay.phase_shape(), device="meta",
                                            requires_grad=s == "u"),
                        "bias": torch.zeros(lay.phase_shape(), device="meta")}
                    for s, lay in (("u", pms[1].layout_u),
                                   ("v", pms[1].layout_v))}]
    with pytest.raises(ValueError, match="diag buffer or a noise"):
        ops.mesh_densify_stacked(pms, params, noisy, ph.NoiseModel())
    assert stub_launches == ["mesh_densify_stacked", "mesh_densify_grad"]
