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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import photonic as jph
from repro_torch.core import photonic as ph
from repro_torch.kernels import mesh_apply as mesh
from repro_torch.kernels import ops, ref


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
