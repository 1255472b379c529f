"""The dense backward of ``kernels/mesh_apply.py`` on the CPU: its plain
version (``ref.mesh_apply_dense_grad_ref``: dx = dy·Mᵀ and dM = xᵀ·dy from
route B's x and dense scratch M, then dphases by ``mesh_apply_grad_ref``
on M's identity rows) against ``jax.vjp`` of the JAX package's
``photonic.mesh_apply_stacked``; which backward design each forward route
reaches (``grad_design``), onn's BP step at hidden 1024 included; and
``MeshApplyFn`` with its launches stubbed on torch's ``meta`` device,
which takes the card's branch: a route-B forward saves x and M and its
backward is the dense one.

The CUDA kernels (``csrc/mesh_apply.cu``: ``mesh_product_kernel`` with a
transposed operand, the warp-rows walk on M's rows) run on the card only
(``tests/test_torch_gpu.py``, ``chip_smoke.py``'s ``mesh-grad-wide``).
Tolerance: ``1e-5·max|want| + 1e-6`` per output, as
``tests/test_torch_mesh_grad.py`` holds the plain backward (the same f32
products summed in other orders, M's states recovered level by level).
"""

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
from test_torch_mesh_grad import _close, _jit_vjp
from test_torch_pinn import share_cores  # noqa: F401 (autouse)


def _inputs(ports, S, B, shared, seed):
    rng = np.random.RandomState(seed)
    layout = ph.rectangular_layout(ports)
    phases = rng.standard_normal((S, *layout.phase_shape())).astype(
        np.float32)
    diag = np.where(rng.rand(S, ports) < 0.5, -1.0, 1.0).astype(np.float32)
    x = rng.standard_normal((B, ports) if shared else (S, B, ports)).astype(
        np.float32)
    dy = rng.standard_normal((S, B, ports)).astype(np.float32)
    return layout, phases, diag, x, dy


def _dense(layout, phases, diag, transpose):
    """Route B's scratch M: the mesh on the identity rows (route A on the
    identity feed gives the plain version's bits)."""
    S, P = phases.shape[0], layout.ports
    eye = torch.eye(P).expand(S, -1, -1)
    return ph.mesh_apply_stacked(layout, phases, diag, eye, transpose)


def _jax_grads(ports, phases, diag, x, dy, transpose):
    jl = jph.rectangular_layout(ports)
    return _jit_vjp(lambda p, xx: jph.mesh_apply_stacked(
        jl, p, jnp.asarray(diag), xx, transpose), phases, x, cotangent=dy)


@pytest.mark.parametrize("ports,shared,S,transpose", [
    (p, *case) for p in (16, 64, 144)
    for case in ((False, 1, False), (True, 3, True), (False, 3, False))]
    + [(16, False, 1, True)])
def test_dense_grad_ref_matches_jax(ports, shared, S, transpose):
    """dx and dphases of the dense backward's plain version, from x and
    M, against ``jax.vjp`` of the JAX package's mesh on the same rows
    (rows per entry at 1.5 × ports, route B's threshold; a shared x's
    gradient sums over the stack), per-entry and shared x, S = 1 and 3,
    transposed and not, at every width."""
    B = int(mesh.DENSE_MIN_ROWS_PER_PORT * ports)
    layout, phases, diag, x, dy = _inputs(ports, S, B, shared,
                                          ports + 2 * S + transpose)
    tp, td = torch.tensor(phases), torch.tensor(diag)
    dense = _dense(layout, tp, td, transpose)
    dx, dph = ref.mesh_apply_dense_grad_ref(layout, tp, td, torch.tensor(x),
                                            dense, torch.tensor(dy),
                                            transpose)
    assert dx.shape == x.shape and dph.shape == phases.shape
    jp, jx = _jax_grads(ports, phases, diag, x, dy, transpose)
    _close(dx, jx)
    _close(dph, jp)


def test_a_transposed_dm_is_caught():
    """The check above catches a planted fault: dM = dyᵀ·x (transposed)
    walked back gives dphases far outside the tolerance."""
    layout, phases, diag, x, dy = _inputs(64, 1, 96, False, 5)
    tp, td = torch.tensor(phases), torch.tensor(diag)
    dense = _dense(layout, tp, td, False)
    bad_dm = (torch.tensor(x).transpose(-1, -2) @ torch.tensor(dy)
              ).transpose(-1, -2)
    _, bad = ref.mesh_apply_grad_ref(layout, tp, td, torch.eye(64)[None],
                                     dense, bad_dm.contiguous())
    jp, _ = _jax_grads(64, phases, diag, x, dy, False)
    with pytest.raises(AssertionError):
        _close(bad, jp)
    assert np.abs(bad.numpy() - np.asarray(jp)).max() > \
        100 * (1e-5 * np.abs(np.asarray(jp)).max() + 1e-6)


@pytest.mark.parametrize("P", [16, 138, 139, 144, 160, 512, 1024])
def test_backward_design_follows_the_forward_route(P):
    """``grad_design(layout, S, rows)`` is ``"dense"`` exactly where the
    forward takes route B (``wide_route``), the resident backward where
    it fits, the warp-rows one elsewhere; without rows (a backward handed
    y) the layout's walk design."""
    layout = ph.rectangular_layout(P)
    for S in (1, 11):
        for rows in (21, 100, int(1.5 * P) - 1, int(1.5 * P), 4300):
            route = chip_smoke._mesh_route(layout, rows, S)
            want = ("resident" if mesh.grad_fits(layout) else
                    "dense" if route == "dense" else "warp_rows")
            assert mesh.grad_design(layout, S, rows) == want
    assert mesh.grad_design(layout) == ("resident" if mesh.grad_fits(layout)
                                        else "warp_rows")
    if P == 1024:
        assert mesh.grad_design(layout, 1, 4300) == "dense"
        assert mesh.grad_design(layout, 1, 100) == "warp_rows"
        assert mesh.grad_design(layout, 1, 21) == "warp_rows"


def test_onn_1024_step_backwards_by_design():
    """onn's BP step at hidden 1024 (hjb-20d, batch 100, fd_fast): its six
    meshes' backwards by the design each forward's route picks are
    ``chip_smoke.ONN_1024_STEP``'s (2 resident, 2 warp rows, 2 dense), and
    Table 1's off-chip ONN epoch's (the stencil's 4300 rows through all 4
    meshes) ``TABLE1_ONN_1024_EPOCH``'s (1 resident, 3 dense)."""
    n, batch = 21, 100
    v0, u0, wide = (ph.rectangular_layout(p) for p in (n, 1024, 1024))
    step = dict.fromkeys(mesh.GRAD_DESIGNS, 0)
    for layout, rows in ((v0, batch), (v0, n), (u0, batch), (u0, n),
                         (wide, (2 * n + 1) * batch),
                         (wide, (2 * n + 1) * batch)):
        step[mesh.grad_design(layout, 1, rows)] += 1
    assert step == chip_smoke.ONN_1024_STEP[1]
    epoch = dict.fromkeys(mesh.GRAD_DESIGNS, 0)
    for layout in (v0, u0, wide, wide):
        epoch[mesh.grad_design(layout, 1, 43 * batch)] += 1
    assert {f"grad_{k}": v for k, v in epoch.items() if v} == {
        k: v for k, v in chip_smoke.TABLE1_ONN_1024_EPOCH.items()
        if k.startswith("grad_")}


def test_dense_grad_splits_fill_the_card():
    """dM's split over its k tiles: every split holds at least one tile,
    the splits cover all of them, and at 1024 ports on 4300 rows the grid
    holds 4 splits of 34 tiles (256 blocks on 132 SMs)."""
    assert mesh.dense_grad_splits(1, 1024, 4300, 132) == (4, 34)
    for S, P, B in ((1, 1024, 4300), (3, 160, 777), (2, 1024, 4300),
                    (11, 1024, 1600), (1, 16, 24), (1, 1024, 1536)):
        splits, per = mesh.dense_grad_splits(S, P, B, 132)
        ktiles = -(-B // 32)
        assert splits >= 1 and (splits - 1) * per < ktiles <= splits * per
        assert S * splits <= mesh.MAX_STACK


@pytest.fixture
def stub_launches(monkeypatch):
    """The forward and backward wrappers replaced by stand-ins that record
    their calls and return ``meta`` tensors of the kernels' shapes."""
    calls = []

    def apply(layout, phases, diag, x, transpose=False):
        calls.append("mesh_apply_stacked")
        return torch.empty((phases.shape[0], x.shape[-2], layout.ports),
                           device=x.device)

    def keep(layout, phases, diag, x, transpose=False):
        calls.append("launch_dense_keep")
        S, P = phases.shape[0], layout.ports
        return (torch.empty((S, x.shape[-2], P), device=x.device),
                torch.empty((S, P, P), device=x.device))

    def apply_grad(layout, phases, diag, y, dy, transpose=False,
                   need_dx=True, need_dphases=True, **kept):
        design = ("dense" if kept.get("dense") is not None
                  else mesh.grad_design(layout))
        calls.append(("mesh_apply_stacked_grad", design, need_dx,
                      need_dphases, y is None,
                      tuple(sorted(k for k, v in kept.items()
                                   if v is not None))))
        S, B = phases.shape[0], dy.shape[1]
        return (torch.empty((S, B, layout.ports), device=dy.device)
                if need_dx else None,
                torch.empty_like(phases) if need_dphases else None)

    monkeypatch.setattr(mesh, "mesh_apply_stacked", apply)
    monkeypatch.setattr(mesh, "launch_dense_keep", keep)
    monkeypatch.setattr(mesh, "mesh_apply_stacked_grad", apply_grad)
    return calls


@pytest.mark.parametrize("shared", [False, True])
def test_mesh_apply_fn_saves_x_and_m_for_the_dense_backward(stub_launches,
                                                           shared):
    """Under grad a 1024-port mesh on 1600 rows (route B) goes through
    ``MeshApplyFn`` keeping x and M (not y) and its backward is the
    dense one, handed x and M; on 100 rows (route A) it keeps y and its
    backward is the warp-rows one; a 16-port mesh the resident one.  A
    shared x's gradient comes back (B, P)."""
    P = 1024
    phases = torch.zeros((2, *ph.rectangular_layout(P).phase_shape()),
                         device="meta", requires_grad=True)
    diag = torch.ones(P, device="meta")
    for B, design in ((1600, "dense"), (100, "warp_rows")):
        layout = ph.rectangular_layout(P)
        x = torch.zeros((B, P) if shared else (2, B, P), device="meta",
                        requires_grad=True)
        y = ops.mesh_apply_stacked(layout, phases, diag, x, True)
        saved = y.grad_fn.saved_tensors
        if design == "dense":
            assert [tuple(t.shape) for t in saved[2:]] == [
                tuple(x.shape), (2, P, P)]
        else:
            assert [tuple(t.shape) for t in saved[2:]] == [(2, B, P)]
        gp, gx = torch.autograd.grad(y, [phases, x], torch.ones_like(y))
        assert gp.shape == phases.shape and gx.shape == x.shape
    small = ph.rectangular_layout(16)
    p16 = torch.zeros((2, *small.phase_shape()), device="meta",
                      requires_grad=True)
    y = ops.mesh_apply_stacked(small, p16, torch.ones(16, device="meta"),
                               torch.zeros((2, 4300, 16), device="meta"))
    torch.autograd.grad(y, [p16], torch.ones_like(y))
    assert stub_launches == [
        "launch_dense_keep",
        ("mesh_apply_stacked_grad", "dense", True, True, True,
         ("dense", "x")),
        "mesh_apply_stacked",
        ("mesh_apply_stacked_grad", "warp_rows", True, True, False, ()),
        "mesh_apply_stacked",
        ("mesh_apply_stacked_grad", "resident", False, True, False, ())]
