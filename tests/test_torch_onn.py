"""The port's ``onn`` mode (the paper's ONN baseline: every weight an SVD pair
of full MZI meshes) and the photonic names it brings, against the JAX
package's, on the CPU.

Params, perturbation stacks and hardware noise come from the JAX side as
numpy trees and reach the port through ``repro_torch.interop``; matrices
and points are made with numpy from a seed.  Tolerances, each with its
reason:

  * ``decompose_orthogonal``: the layouts equal, the phases within 1e-6 (the
    same numpy float64 arithmetic, then one rounding to f32);
  * a mesh made dense, the scan and ``from_dense`` reproduce W within 1e-5
    (f32 rotations over up to 2P levels);
  * one 1024-port mesh (1024 levels) against JAX's gather scan within
    ``WIDE_RTOL``·max|y| (the same f32 rotation per level, sin/cos from
    two libraries, differences compounding over 1024 levels);
  * u-values ``rtol = atol = 1e-5`` (``test_torch_pinn``'s bound: f32 sums
    in another order, sin from two libraries; the JAX stacked path's
    polynomial sin adds ~2 ulp);
  * losses ``rtol = 1e-1`` over ``LOSS_BATCH`` points (the FD residual
    amplifies f32 differences by 1/h² = 1e4);
  * within the port, the stacked path against one model at a time
    ``rtol = 1e-5, atol = 1e-6`` (the head's einsum and matmul sum in other
    orders; the CPU's vectorized sin/cos may round a table's tail apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import photonic as jph
from repro.core import pinn as jpinn
from repro.core import zoo as jzoo
from repro.core.photonic import NoiseModel as JNoise
from repro.kernels.quant import QuantConfig as JQuant
from repro.serving import PdeServingEngine as JEngine
from repro.serving import PointRequest as JRequest
from repro.serving import SolverRegistry as JRegistry
from repro_torch import interop
from repro_torch.checkpoint import read_checkpoint_meta
from repro_torch.core import photonic as tph
from repro_torch.core import pinn as tpinn
from repro_torch.core import zoo as tzoo
from repro_torch.kernels import mesh_apply as tmesh
from repro_torch.kernels import ops as tops
from repro_torch.kernels.quant import QuantConfig as TQuant
from repro_torch.launch import train
from repro_torch.serving import PdeServingEngine, PointRequest, SolverRegistry
from test_torch_pinn import RTOL, ATOL, _np_tree, _points, _port_model, \
    share_cores

WIDE_RTOL = 1e-5
LOSS_BATCH = 96
HIDDEN = 32


def _orthogonal(P, seed):
    q, _ = np.linalg.qr(np.random.RandomState(seed).standard_normal((P, P)))
    return q


# ------------------------------------------------------------ photonic names

@pytest.mark.parametrize("ports", [2, 5, 12])
def test_decompose_orthogonal_matches_jax(ports):
    u = _orthogonal(ports, ports)
    jl, jp, jd = jph.decompose_orthogonal(u)
    tl, tp, td = tph.decompose_orthogonal(u)
    for field in ("idx_a", "idx_b", "mask"):
        np.testing.assert_array_equal(getattr(tl, field), getattr(jl, field))
    assert tp.dtype == td.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("ports", [5, 12])
def test_mesh_matrix_scan_and_from_dense_reproduce_w(ports):
    u = _orthogonal(ports, 10 + ports)
    layout, phases, diag = tph.decompose_orthogonal(u)
    dense = tph.mesh_matrix(layout, phases, diag)
    np.testing.assert_allclose(dense.numpy(), u, rtol=0, atol=1e-5)
    jdense = jph.mesh_matrix(*jph.decompose_orthogonal(u))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=0,
                               atol=1e-5)
    # the stacked form: entry s of a stack is mesh_matrix of phases[s]
    stack = torch.stack([phases, phases + 0.1])
    dense_s = tph.mesh_matrix_stacked(layout, stack, diag)
    assert torch.equal(dense_s[0], dense)
    np.testing.assert_allclose(
        dense_s[1].numpy(),
        tph.mesh_matrix(layout, phases + 0.1, diag).numpy(), rtol=0,
        atol=1e-6)
    # the scan oracle agrees with the gather form and with JAX's scan
    x = np.random.RandomState(ports).standard_normal((3, ports)).astype(
        np.float32)
    for transpose in (False, True):
        scan = tph.mesh_apply_scan(layout, phases, diag, torch.tensor(x),
                                   transpose)
        gather = tph.mesh_apply(layout, phases, diag, torch.tensor(x),
                                transpose)
        np.testing.assert_allclose(scan.numpy(), gather.numpy(), rtol=0,
                                   atol=1e-5)
        jscan = jph.mesh_apply_scan(layout, jnp.asarray(phases.numpy()),
                                    jnp.asarray(diag.numpy()),
                                    jnp.asarray(x), transpose)
        np.testing.assert_allclose(scan.numpy(), np.asarray(jscan), rtol=0,
                                   atol=1e-5)
    # from_dense maps a trained W onto two decomposed meshes
    w = np.random.RandomState(1).standard_normal((ports, ports - 2))
    pm, jpm = tph.PhotonicMatrix(*w.shape), jph.PhotonicMatrix(*w.shape)
    params, jparams = pm.from_dense(w), jpm.from_dense(w)
    np.testing.assert_allclose(pm.to_dense(params).numpy(), w, rtol=0,
                               atol=1e-5)
    for key in params:
        np.testing.assert_allclose(params[key].numpy(),
                                   np.asarray(jparams[key]), rtol=0,
                                   atol=1e-6)
    assert pm.num_mzis == jpm.num_mzis


def test_mzi_counts_match_table_2():
    # Table 2's ONN count (benchmarks/table2_cost.py:4): 2.10e6 MZIs
    assert 2 * tph.mzi_count_matrix(1024, 1024) == 2_095_104
    assert tph.mzi_count_matrix(1024, 21) == jph.mzi_count_matrix(1024, 21)
    assert tph.PhotonicMatrix(1024, 21).num_mzis == \
        tph.mzi_count_matrix(1024, 21)


def test_wide_mesh_matches_jax_gather_scan():
    """One 1024-port rectangular mesh (1024 levels), the width of onn's
    hidden layer, on 4 rows against JAX's gather scan, both directions."""
    layout_j, layout_t = jph.rectangular_layout(1024), \
        tph.rectangular_layout(1024)
    rng = np.random.RandomState(1024)
    phases = (0.1 * rng.standard_normal(layout_j.phase_shape())).astype(
        np.float32)
    diag = rng.choice([-1.0, 1.0], 1024).astype(np.float32)
    x = rng.standard_normal((4, 1024)).astype(np.float32)
    for transpose in (False, True):
        want = np.asarray(jph.mesh_apply(layout_j, jnp.asarray(phases),
                                         jnp.asarray(diag), jnp.asarray(x),
                                         transpose))
        got = tops.mesh_apply(layout_t, torch.tensor(phases),
                              torch.tensor(diag), torch.tensor(x),
                              transpose).numpy()
        # reads 5.0e-6 (3.5e-6 transposed) of max|y| on an x86 CPU
        assert np.abs(got - want).max() <= WIDE_RTOL * np.abs(want).max()


def test_mesh_design_and_stream_rows():
    """The resident design up to 138 ports of a rectangular mesh, the wide
    routes above; rows per owner-walk block at the shapes of an onn step
    (132 SMs of an H100)."""
    assert tmesh.mesh_design(tph.rectangular_layout(16)) == "resident"
    assert tmesh.mesh_design(tph.rectangular_layout(138)) == "resident"
    for ports in (139, 160, 1024):
        assert tmesh.mesh_design(tph.rectangular_layout(ports)) == "wide"
    # Reck-ordered layouts have 2P - 3 levels: 40 ports fit, 100 do not
    reck, _, _ = tph.decompose_orthogonal(_orthogonal(40, 0))
    assert tmesh.mesh_design(reck) == "resident"
    reck, _, _ = tph.decompose_orthogonal(_orthogonal(100, 0))
    assert reck.levels == 197 and tmesh.mesh_design(reck) == "wide"
    assert tmesh.DESIGNS == ("resident", "warp_rows", "dense", "owner_walk")
    wide = tph.rectangular_layout(1024)
    assert tph.mesh_owner_plan(wide).shape == (1024, 513)
    # hidden layer 11 x 4300: 96 tiles of 45 rows, 8 whole waves
    assert tmesh.stream_rows(wide, 11, 4300, 132) == 45
    assert tmesh.stream_rows(wide, 11, 100, 132) == 9
    assert tmesh.stream_rows(wide, 11, 21, 132) == 2
    assert tmesh.stream_rows(wide, 1, 4300, 132) == 33
    rows = tmesh.stream_rows(wide, 1, 10**6, 132)
    assert tmesh.stream_smem_bytes(1024, 513, rows) <= tmesh.SMEM_MAX_BYTES
    assert tmesh.stream_smem_bytes(1024, 513, rows + 1) > tmesh.SMEM_MAX_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        tmesh.stream_rows(tph.rectangular_layout(8000), 1, 4, 132)


def test_owner_plan_covers_every_wire_once():
    for layout in (tph.rectangular_layout(7), tph.rectangular_layout(8),
                   tph.decompose_orthogonal(_orthogonal(9, 3))[0]):
        perm, _, _ = tph.mesh_gather_plan(layout)
        for c, row in enumerate(tph.mesh_owner_plan(layout)):
            owners = row[row >= 0]
            touched = np.concatenate([owners, perm[c, owners]])
            touched = np.unique(touched)
            np.testing.assert_array_equal(touched, np.arange(layout.ports))
            assert (row[len(owners):] == -1).all()


def test_mesh_entries_dispatch_on_the_device():
    """On the CPU ``ops.mesh_apply`` is the plain gather form and no kernel
    launches; the kernel's launch functions refuse CPU tensors."""
    layout = tph.rectangular_layout(200)
    phases = torch.zeros(layout.phase_shape())
    x = torch.randn(3, 200)
    before = dict(tmesh.mesh_apply_stacked.design_launches)
    y = tops.mesh_apply(layout, phases, torch.ones(200), x)
    assert torch.equal(y, tph.mesh_apply(layout, phases, torch.ones(200), x))
    assert tmesh.mesh_apply_stacked.design_launches == before
    for launch in (tmesh.launch_resident, tmesh.launch_warp_rows,
                   tmesh.launch_dense, tmesh.launch_owner_walk):
        with pytest.raises(ValueError, match="CUDA"):
            launch(layout, phases[None], torch.ones(200), x)


# ----------------------------------------------------------------- onn mode

def _onn(noise, hidden=HIDDEN, seed=0, fused=True):
    cfg = jpinn.PINNConfig(hidden=hidden, mode="onn", pde="hjb-20d",
                           deriv="fd_fast" if fused else "fd",
                           use_fused_kernel=fused,
                           noise=JNoise(enabled=noise))
    jm = jpinn.TensorPinn(cfg)
    key = jax.random.PRNGKey(seed)
    params = jm.init(key)
    hw = jm.sample_noise(jax.random.fold_in(key, 99))
    return cfg, jm, params, hw


def _to_port(params, hw):
    return (interop.params_from_numpy(_np_tree(params), "cpu"),
            interop.noise_from_numpy(_np_tree(hw), "cpu"))


def test_onn_init_and_noise_trees_match_jax():
    """The same tree keys and shapes (the input is not padded: layer 0 is
    a hidden × 21 matrix), the same fixed buffers, noise for every mesh."""
    cfg, jm, params, hw = _onn(True)
    tm = _port_model(cfg)
    assert tm.in_pad == tm.net_in == 21 and tm.uses_noise
    tp = tm.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(np.shape, _np_tree(params)) == \
        tzoo.tree_map(lambda t: tuple(t.shape), tp)
    assert tp["p0"]["phases_v"].shape == \
        tph.rectangular_layout(21).phase_shape()
    tn = tm.sample_noise(torch.Generator().manual_seed(1))
    assert jax.tree.map(np.shape, _np_tree(hw)) == \
        tzoo.tree_map(lambda t: tuple(t.shape), tn)
    mask = tm.trainable_mask(tp)
    assert mask["p0"]["diag_u"] is False and mask["p1"]["phases_u"] is True
    assert _port_model(_onn(False)[0]).sample_noise(
        torch.Generator()) is None


@pytest.mark.parametrize("noise", [False, True])
def test_onn_forward_matches_jax(noise):
    """u, the single FD stencil and the stacked one (with the chip's noise
    shared across the stack) against JAX at hidden 32."""
    cfg, jm, params, hw = _onn(noise, seed=int(noise))
    tm = _port_model(cfg)
    tp, tn = _to_port(params, hw)
    pts = _points(9, 21, seed=5)
    np.testing.assert_allclose(
        tm.u(tp, torch.tensor(pts), tn).numpy(),
        np.asarray(jm.u(params, jnp.asarray(pts), hw)), rtol=RTOL, atol=ATOL)
    h = tm.fd_step
    np.testing.assert_allclose(
        tm.fd_u_stencil(tp, torch.tensor(pts), h, tn).numpy(),
        np.asarray(jm.fd_u_stencil(params, jnp.asarray(pts), h, hw)),
        rtol=RTOL, atol=ATOL)
    xis = jzoo.sample_perturbations(jax.random.PRNGKey(7), params, 3,
                                    jm.trainable_mask(params))
    stacked = jax.tree.map(
        lambda p, z: p + 0.01 * jnp.concatenate([jnp.zeros_like(z[:1]), z]),
        params, xis)
    want = np.asarray(jm.fd_u_stencil_stacked(stacked, jnp.asarray(pts), h,
                                              hw))
    ts = interop.params_from_numpy(_np_tree(stacked), "cpu")
    got = tm.fd_u_stencil_stacked(ts, torch.tensor(pts), h, tn)
    assert tuple(got.shape) == (4, 43, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # within the port: entry p of the stack is model p alone
    for p in (0, 2):
        single = tm.fd_u_stencil(
            tzoo.tree_map(lambda t: t[p], ts), torch.tensor(pts), h, tn)
        np.testing.assert_allclose(single.numpy(), got[p].numpy(),
                                   rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        tm.u_stacked(ts, torch.tensor(pts), tn)[0].numpy(),
        tm.u(tzoo.tree_map(lambda t: t[0], ts), torch.tensor(pts),
             tn).numpy(), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_onn_stacked_losses_match_jax_at_the_fd_floor(fused):
    """(P,) losses over ``LOSS_BATCH`` points against JAX (fd_fast and fd),
    and the port's sequential loss of entry 0 against its stacked one."""
    cfg, jm, params, hw = _onn(True, seed=3, fused=fused)
    tm = _port_model(cfg)
    xis = jzoo.sample_perturbations(jax.random.PRNGKey(8), params, 2,
                                    jm.trainable_mask(params))
    stacked = jax.tree.map(
        lambda p, z: p + 0.01 * jnp.concatenate([jnp.zeros_like(z[:1]), z]),
        params, xis)
    xt = _points(LOSS_BATCH, 21, seed=11)
    want = np.asarray(jpinn.residual_losses_stacked(
        jm, stacked, jnp.asarray(xt), hw))
    ts = interop.params_from_numpy(_np_tree(stacked), "cpu")
    _, tn = _to_port(params, hw)
    got = tpinn.residual_losses_stacked(tm, ts, torch.tensor(xt), tn)
    assert got.shape == (3,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-1)
    seq = tpinn.residual_loss(tm, tzoo.tree_map(lambda t: t[0], ts),
                              torch.tensor(xt), tn)
    np.testing.assert_allclose(float(seq), float(got[0]), rtol=1e-1)


def test_onn_zo_step_leaves_the_diag_buffers_bit_identical():
    cfg, jm, params, hw = _onn(True, hidden=16)
    tm = _port_model(cfg)
    tp, tn = _to_port(params, hw)
    xt = torch.tensor(_points(16, 21, seed=2))
    mask = tm.trainable_mask(tp)
    new, _, loss = tzoo.zo_signsgd_step(
        tp, tzoo.ZOState(step=0, seed=1), 1e-2, tzoo.SPSAConfig(num_samples=4),
        lambda sp: tpinn.residual_losses_stacked(tm, sp, xt, tn),
        trainable_mask=mask)
    assert torch.isfinite(loss)
    for i in (0, 1):
        for key in tph.PHOTONIC_BUFFER_KEYS:
            assert torch.equal(new[f"p{i}"][key], tp[f"p{i}"][key])
        assert not torch.equal(new[f"p{i}"]["phases_u"],
                               tp[f"p{i}"]["phases_u"])


ONN_ARGS = ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--pinn-mode", "onn",
            "--pinn-noise", "--reduced", "--device", "cpu", "--batch", "8",
            "--zo-samples", "3", "--log-every", "100"]


def test_onn_trainer_checkpoint_resume_and_serve(tmp_path):
    """3 reduced steps of the trainer with a checkpoint: it carries the
    chip's noise, ``--resume`` from step 2 repeats step 2 bit for bit, and
    the registry serves it without ``hw_noise=``, equal to a direct
    ``model.u``."""
    res = train.main(ONN_ARGS + ["--steps", "3", "--ckpt-dir",
                                 str(tmp_path), "--ckpt-every", "2"])
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert res.val_mse is not None and np.isfinite(res.val_mse)
    meta = read_checkpoint_meta(tmp_path)
    assert meta["pinn"]["mode"] == "onn" and "train_seed" in meta
    assert "hw_noise/p0/u/gamma" in meta["keys"]
    init, _ = train.init_solver(res.model, 0)
    for key in tph.PHOTONIC_BUFFER_KEYS:
        assert torch.equal(res.params["p1"][key], init["p1"][key])
    reg = SolverRegistry(device="cpu")
    solver = reg.load_checkpoint("onn", tmp_path, device="cpu")
    assert solver.noise is not None and "p0" in solver.params
    engine = PdeServingEngine(reg, slots=2, slot_points=16, device="cpu")
    pts = _points(37, 21, seed=4)
    req = engine.submit(PointRequest("onn", pts))
    engine.run()
    with torch.no_grad():
        want = res.model.u(res.params, torch.tensor(pts),
                           res.hw_noise).numpy()
    np.testing.assert_allclose(req.out, want, rtol=1e-6, atol=1e-6)
    # resume from step_2: step 2 again, with its batch and perturbations
    import shutil
    shutil.rmtree(tmp_path / f"step_{3:012d}")
    resumed = train.main(ONN_ARGS + ["--steps", "3", "--ckpt-dir",
                                     str(tmp_path), "--resume"])
    assert resumed.losses == res.losses[2:]


def test_onn_quantized_request_matches_jax():
    """An int8 request with 8-bit DAC phases to an onn solver: JAX snaps
    the phases inside ``apply`` (and has no TT cores to quantize); so does
    the port, and the two engines serve the same values."""
    cfg, jm, params, hw = _onn(True, hidden=16, seed=4)
    jreg = JRegistry()
    jreg.register("onn", jm, params, hw_noise=hw)
    tm = _port_model(cfg)
    treg = SolverRegistry(device="cpu")
    tp, tn = _to_port(params, hw)
    treg.register("onn", tm, tp, hw_noise=tn)
    pts = _points(23, 21, seed=6)
    jq = JQuant(enabled=True, dtype="int8", phase_bits=8)
    tq = TQuant(enabled=True, dtype="int8", phase_bits=8)
    jeng = JEngine(jreg, slots=2, slot_points=16)
    teng = PdeServingEngine(treg, slots=2, slot_points=16, device="cpu")
    jr = jeng.submit(JRequest("onn", pts, quant=jq))
    tr = teng.submit(PointRequest("onn", pts, quant=tq))
    f32 = teng.submit(PointRequest("onn", pts))
    jeng.run()
    teng.run()
    np.testing.assert_allclose(tr.out, jr.out, rtol=RTOL, atol=ATOL)
    assert np.abs(tr.out - f32.out).max() > 1e-4      # the snap bites


def test_onn_bp_and_qat_exit_with_their_roadmap_items():
    with pytest.raises(SystemExit, match=r"onn.*item 6c-3"):
        train.main(ONN_ARGS + ["--steps", "1", "--optimizer", "adamw",
                               "--hidden", "1040"])
    with pytest.raises(SystemExit, match=r"onn.*item 11"):
        train.main(ONN_ARGS + ["--steps", "1", "--quant", "int8"])


# ------------------------------------------ tonn: one grouped densification

def test_prepare_params_is_one_grouped_densification(monkeypatch):
    """Without grad, tonn's ``prepare_params`` is ``prepare_params_stacked``
    over a stack of one: one ``mesh_densify_stacked`` call for every core
    matrix, bit-equal to the plain per-matrix densification that the BP
    baselines differentiate (``prepare_params_plain``)."""
    cfg = jpinn.PINNConfig(hidden=64, mode="tonn", tt_L=3, pde="hjb-20d",
                           noise=JNoise(enabled=True))
    tm = _port_model(cfg)
    params = tm.init(torch.Generator().manual_seed(0))
    noise = tm.sample_noise(torch.Generator().manual_seed(1))
    calls = []
    real = tops.mesh_densify_stacked

    def counted(*args, **kw):
        calls.append(len(args[0]))
        return real(*args, **kw)

    monkeypatch.setattr(tops, "mesh_densify_stacked", counted)
    with torch.no_grad():
        prepared, eff = tm.prepare_params(params, noise)
    assert calls == [6] and eff is None
    plain, _ = tm.prepare_params_plain(params, noise)
    assert calls == [6]
    for i in (0, 1):
        for a, b in zip(prepared[f"cores{i}"], plain[f"cores{i}"]):
            assert a.shape == b.shape and a.is_contiguous()
            assert torch.equal(a, b)
    with torch.no_grad():
        pts = torch.tensor(_points(5, 21, seed=1))
        tm.u(params, pts, noise)
    assert calls == [6, 6]
