"""The port's off-chip BP baselines against the JAX package's, on the CPU.

The backward of the TT chain: ``ref.tt_contract_grad_ref`` (the plain
version of the ``tt_contract_grad`` kernel) against ``torch.autograd`` of
``tt_contract_ref`` and ``jax.vjp`` of the JAX package's chain, and the
autograd Function around the kernels (``TTContractFn``) with the kernels
swapped for their plain versions.  Then ``dense`` mode, the BP gradients of
``residual_loss`` in dense, tt and tonn, and the trainer's BP CLI, whose
``opt`` checkpoint subtree JAX's ``restore_checkpoint`` reads.

Tolerances.  The reverse chain: ``1e-5·max|want| + 1e-6`` per output (the
same f32 products summed in another order; a core's gradient sums B·M_<k·
N_>k of them).  Gradients of a u-level functional (Σ u·w over 96 points):
``1e-5·max|g|`` per leaf (the same f32 chain; measured ≤ 1e-6).  Loss
gradients sit at the FD noise floor: the residual's second differences
amplify the u-values' last-ulp differences by 1/h² = 1e4, so two correct
f32 paths give losses 2–15% apart and loss gradients 7–13% apart in
relative L2 over 96 points (measured; the port's f32 is the nearer of the
two to a float64 run of the port); held at ``rtol = 2.5e-1`` and relative
L2 ``2.5e-1``.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.core import pinn as jpinn
from repro.core import tt as jtt
from repro.core.photonic import NoiseModel as JNoise
from repro.optim import optimizers as jopt
from repro_torch import interop
from repro_torch.checkpoint import read_checkpoint_meta
from repro_torch.core import pinn as tpinn
from repro_torch.core import tt, zoo
from repro_torch.kernels import ref
from repro_torch.kernels import tt_contract as ttc
from repro_torch.launch import train
from repro_torch.optim import get_optimizer
from test_torch_pinn import _np_tree, _points, _port_model, share_cores

LOSS_BATCH = 96

SPECS = {
    "paper": tt.PAPER_TONN_SPEC,
    "reduced": tt.auto_factorize(64, 64, L=3, max_rank=2),
    "rank4": tt.auto_factorize(256, 512, L=3, max_rank=4),
    "odd": tt.TTSpec(out_modes=(3, 5), in_modes=(4, 5), ranks=(1, 3, 1)),
}


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max() + 1e-6)


def _chain_inputs(spec, batch_shape, seed):
    rng = np.random.RandomState(seed)
    cores = [(rng.standard_normal(s) * 0.3).astype(np.float32)
             for s in spec.core_shapes]
    x = rng.standard_normal((*batch_shape, spec.in_dim)).astype(np.float32)
    dy = rng.standard_normal((*batch_shape, spec.out_dim)).astype(np.float32)
    return cores, x, dy


@pytest.mark.parametrize("label", sorted(SPECS))
def test_grad_ref_matches_autograd_and_jax(label):
    spec = SPECS[label]
    cores, x, dy = _chain_inputs(spec, (5, 3), seed=len(label))
    tc = [torch.tensor(c, requires_grad=True) for c in cores]
    tx = torch.tensor(x, requires_grad=True)
    y = ref.tt_contract_ref(tx, tc, spec)
    auto = torch.autograd.grad(y, [tx, *tc], torch.tensor(dy))
    dx, dgs = ref.tt_contract_grad_ref(torch.tensor(x),
                                       [torch.tensor(c) for c in cores], spec,
                                       torch.tensor(dy))
    jspec = jtt.TTSpec(spec.out_modes, spec.in_modes, spec.ranks)
    _, vjp = jax.vjp(lambda xx, cs: jtt.tt_matvec(cs, xx, jspec),
                     jnp.asarray(x), [jnp.asarray(c) for c in cores])
    jdx, jdg = vjp(jnp.asarray(dy))
    assert dx.shape == tx.shape
    _close(dx, auto[0].numpy())
    _close(dx, jdx)
    for got, a, j, shape in zip(dgs, auto[1:], jdg, spec.core_shapes):
        assert tuple(got.shape) == shape and got.is_contiguous()
        _close(got, a.numpy())
        _close(got, j)
    none, again = ref.tt_contract_grad_ref(
        torch.tensor(x), [torch.tensor(c) for c in cores], spec,
        torch.tensor(dy), need_dx=False)
    assert none is None
    assert all(torch.equal(a, b) for a, b in zip(again, dgs))


@pytest.fixture
def plain_kernels(monkeypatch):
    """The forward launch and ``tt_contract_grad`` replaced by their plain
    versions, which insist on what the kernels take (contiguous inputs,
    no grad inside the forward), and count their calls."""
    calls = {"forward": 0, "grad": []}

    def forward(x, cores, spec):
        assert not torch.is_grad_enabled()
        assert x.is_contiguous() and all(c.is_contiguous() for c in cores)
        calls["forward"] += 1
        return ref.tt_contract_ref(x, cores, spec)

    def grad(x, cores, spec, dy, need_dx=True):
        assert x.is_contiguous() and dy.is_contiguous()
        calls["grad"].append(need_dx)
        return ref.tt_contract_grad_ref(x, cores, spec, dy, need_dx)

    monkeypatch.setattr(ttc, "_launch", forward)
    monkeypatch.setattr(ttc, "tt_contract_grad", grad)
    return calls


@pytest.mark.parametrize("x_needs_grad", [False, True])
def test_autograd_function_runs_the_kernels_both_ways(plain_kernels,
                                                      x_needs_grad):
    """``tt_contract`` on inputs that require grad runs ``TTContractFn``:
    the forward launch, then the backward entry, with ``dx`` only where x
    needs it, on strided inputs made contiguous, and the gradients autograd
    of the plain chain gives."""
    spec = SPECS["reduced"]
    cores, x, dy = _chain_inputs(spec, (6,), seed=3)
    tc = [torch.tensor(c, requires_grad=True) for c in cores]
    base = torch.tensor(np.ascontiguousarray(x.T)).requires_grad_(
        x_needs_grad)
    tx = base.T                                      # a strided view
    y = ttc.tt_contract(tx, tc, spec)
    assert isinstance(y.grad_fn, ttc.TTContractFn._backward_cls)
    torch.autograd.backward(y, torch.tensor(dy))
    assert plain_kernels == {"forward": 1, "grad": [x_needs_grad]}
    wx = torch.tensor(x, requires_grad=True)
    wc = [torch.tensor(c, requires_grad=True) for c in cores]
    want = torch.autograd.grad(ref.tt_contract_ref(wx, wc, spec), [wx, *wc],
                               torch.tensor(dy))
    for c, w in zip(tc, want[1:]):
        _close(c.grad, w.numpy())
    if x_needs_grad:
        _close(base.grad.T, want[0].numpy())
    else:
        assert base.grad is None


def test_raw_kernel_refuses_inputs_that_require_grad(monkeypatch):
    """The forward launch never sees an input that requires grad with grad
    enabled: ``tt_contract`` hands such inputs to ``TTContractFn``, whose
    forward runs the launch with grad off, so the output has a grad_fn;
    without grad the launch runs bare.  The launch itself refuses CPU
    tensors either way."""
    spec = SPECS["reduced"]
    cores = [torch.zeros(s) for s in spec.core_shapes]
    x = torch.zeros(2, spec.in_dim, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        ttc.tt_contract(x, cores, spec)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ttc.tt_contract(x, cores, spec)
    seen = []

    def launch(x, cores, spec):
        seen.append(torch.is_grad_enabled())
        return ref.tt_contract_ref(x, cores, spec)

    monkeypatch.setattr(ttc, "_launch", launch)
    assert ttc.tt_contract(x, cores, spec).grad_fn is not None
    with torch.no_grad():
        assert ttc.tt_contract(x, cores, spec).grad_fn is None
    assert ttc.tt_contract(x.detach(), cores, spec).grad_fn is None
    assert seen == [False, False, True]


def test_kernels_without_a_backward_refuse_grad_before_launching(
        monkeypatch):
    """``ops.tt_linear_batched`` (f32 and quantized), ``ops.attention`` and
    the mesh entries on a layout of the owner walk (160 ports paired (a,
    a+2)) on a tensor off the CPU that requires grad raise before their
    launch, the meshes naming item 6c-3; under ``no_grad`` the same calls
    reach it.  Under grad a resident layout, a layout of route A (140
    ports: the warp-rows backward) and the grouped densification reach
    their autograd Functions instead.  The launches are stubbed and the
    tensors are on torch's ``meta`` device, which takes the card's branch
    of the dispatch here."""
    import chip_smoke
    from repro_torch.core import photonic
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant as quant_lib
    launched = []

    def stub(name):
        def launch(x, *args, **kwargs):
            launched.append(name)
            return x
        return launch

    def mesh_stub(layout, phases, diag, x, transpose=False):
        launched.append("mesh_apply_stacked")
        return torch.empty((phases.shape[0], x.shape[-2], layout.ports),
                           device=x.device)

    def densify_stub(matrices, params, *args, **kwargs):
        launched.append("mesh_densify_stacked")
        return [torch.empty((1, pm.out_dim, pm.in_dim), device="meta")
                for pm in matrices]

    for mod, name in ((ttc, "tt_contract_batched"),
                      (ttc, "tt_contract_batched_quant"),
                      (fa, "flash_attention")):
        monkeypatch.setattr(mod, name, stub(name))
    monkeypatch.setattr(mesh, "mesh_apply_stacked", mesh_stub)
    monkeypatch.setattr(mesh, "mesh_densify_stacked", densify_stub)
    wide, narrow = (photonic.rectangular_layout(p) for p in (140, 16))
    skew = chip_smoke.skew_layout(160)
    assert mesh.mesh_design(skew) == "wide" and mesh.grad_design(skew) is None
    assert mesh.grad_design(wide) == "warp_rows"
    phases = torch.zeros((1, *skew.phase_shape()), device="meta",
                         requires_grad=True)
    rows = torch.zeros((3, 160), device="meta")
    spec = SPECS["reduced"]
    cores = [torch.zeros((3, *s), device="meta") for s in spec.core_shapes]
    x = torch.zeros((5, spec.in_dim), device="meta", requires_grad=True)
    int8 = quant_lib.QuantConfig(enabled=True, dtype="int8")
    q = torch.zeros((1, 2, 4, 8), device="meta", requires_grad=True)
    kv = torch.zeros((1, 1, 4, 8), device="meta")
    calls = {"tt_contract_batched": lambda: ops.tt_linear_batched(
                 x, cores, spec),
             "tt_contract_batched_quant": lambda: ops.tt_linear_batched(
                 x, cores, spec, quant=int8),
             "flash_attention": lambda: ops.attention(q, kv, kv),
             "mesh_apply_stacked": lambda: ops.mesh_apply_stacked(
                 skew, phases, torch.ones(160, device="meta"), rows),
             "mesh_apply": lambda: ops.mesh_apply(
                 skew, phases[0], torch.ones(160, device="meta"), rows)}
    for name, call in calls.items():
        with pytest.raises(ValueError, match=f"{name} on the card has no "
                                             "backward"):
            call()
        assert launched == []
    with pytest.raises(ValueError, match="tt_linear"):
        calls["tt_contract_batched"]()
    with pytest.raises(ValueError, match="item 14a"):
        calls["flash_attention"]()
    with pytest.raises(ValueError, match="item 6c-3"):
        calls["mesh_apply"]()
    with torch.no_grad():
        for call in calls.values():
            call()
    assert launched == ["tt_contract_batched", "tt_contract_batched_quant",
                        "flash_attention", "mesh_apply_stacked",
                        "mesh_apply_stacked"]
    # under grad: the resident design, route A's layouts and the grouped
    # densification launch their forwards through their autograd Functions
    launched.clear()
    for lay in (narrow, wide):
        y = ops.mesh_apply(lay, torch.zeros(lay.phase_shape(), device="meta",
                                            requires_grad=True),
                           torch.ones(lay.ports, device="meta"),
                           torch.zeros((3, lay.ports), device="meta"))
        assert type(y.grad_fn).__name__ == "ViewBackward0"
        assert type(y.grad_fn.next_functions[0][0]).__name__ == \
            "MeshApplyFnBackward"
    pm = photonic.PhotonicMatrix(4, 16)
    p = {"phases_u": torch.zeros((1, *pm.layout_u.phase_shape()),
                                 device="meta", requires_grad=True),
         "phases_v": torch.zeros((1, *pm.layout_v.phase_shape()),
                                 device="meta"),
         "sigma": torch.ones((1, 4), device="meta"),
         "diag_u": torch.ones(4, device="meta"),
         "diag_v": torch.ones(16, device="meta")}
    w, = ops.mesh_densify_stacked([pm], [p], [None])
    assert type(w.grad_fn).__name__ == "MeshDensifyFnBackward"
    assert launched == ["mesh_apply_stacked", "mesh_apply_stacked",
                        "mesh_densify_stacked"]


@pytest.mark.parametrize("rows", [21, 100, 4300])
def test_grad_tile_fits_a_block(rows):
    """The backward's layout at the BP launches of the paper's spec: the
    forward states kept on chip (all four, or all but x where that fits
    more rows; a row buffer more for dA), three blocks an SM, every block
    inside its third of the SM's shared memory, and enough blocks to fill
    the card."""
    tile = ttc.grad_tile(tt.PAPER_TONN_SPEC, rows)
    assert tile.smem_bytes <= ttc.SMEM_BLOCK_BUDGET
    assert tile.stride == 1024 and tile.saved in (3, 4)
    assert tile.buffers == tile.saved + 1 and tile.blocks_per_sm == 3
    assert ttc.grad_grid(tile, rows)[1] >= min(rows, ttc.H100_SMS)
    with pytest.raises(ValueError, match="fibers"):
        ttc.grad_tile(tt.auto_factorize(512, 512, L=2, max_rank=4))


# --------------------------------------------------------------- dense mode

def _jax_dense(fused, seed=2):
    cfg = jpinn.PINNConfig(hidden=64, mode="dense", pde="hjb-20d",
                           deriv="fd_fast", use_fused_kernel=fused)
    jm = jpinn.TensorPinn(cfg)
    return cfg, jm, jm.init(jax.random.PRNGKey(seed))


def test_dense_model_matches_jax():
    """Geometry, init tree, u and the stacked stencil u strictly (JAX's
    unfused path: libm sin), the stacked losses at the FD noise floor
    (JAX's fused path, as its trainer runs it)."""
    cfg, jm, params = _jax_dense(fused=False)
    tm = _port_model(cfg)
    assert tm.in_pad == jm.in_pad == 21 and tm.dims == jm.dims
    assert tm.specs == [] and tm.trainable_mask(tm.init(
        torch.Generator().manual_seed(0))) == jax.tree.map(
            lambda _: True, _np_tree(params))
    gen_shapes = jax.tree.map(lambda t: tuple(t.shape),
                              tm.init(torch.Generator().manual_seed(0)))
    assert gen_shapes == jax.tree.map(np.shape, params)
    tparams = interop.params_from_numpy(_np_tree(params), "cpu")
    pts = _points(19, 21, seed=4)
    with torch.no_grad():
        u = tm.u(tparams, torch.tensor(pts))
    np.testing.assert_allclose(u.numpy(), np.asarray(jm.u(params, pts)),
                               rtol=1e-5, atol=1e-5)
    P = 3
    rng = np.random.RandomState(5)
    stacked = jax.tree.map(
        lambda p: (np.asarray(p)[None]
                   + 0.01 * rng.standard_normal((P, *np.shape(p)))
                   ).astype(np.float32), params)
    xt = _points(LOSS_BATCH, 21, seed=6)
    tstack = interop.params_from_numpy(stacked, "cpu")
    with torch.no_grad():
        got_u = tm.fd_u_stencil_stacked(tstack, torch.tensor(xt[:8]),
                                        tm.fd_step)
    want_u = jm.fd_u_stencil_stacked(jax.tree.map(jnp.asarray, stacked),
                                     jnp.asarray(xt[:8]), jm.fd_step)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=1e-5,
                               atol=1e-5)
    _, jf, _ = _jax_dense(fused=True)
    want = jpinn.residual_losses_stacked(
        jf, jax.tree.map(jnp.asarray, stacked), jnp.asarray(xt))
    with torch.no_grad():
        got = tpinn.residual_losses_stacked(tm, tstack, torch.tensor(xt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.5e-1)


# -------------------------------------------------------------- BP gradients

def _grad_setup(mode, hidden=64):
    """A JAX solver (fused config, the BP trainer's), its params and noise,
    96 collocation points and a fixed weighting of u over them."""
    cfg = jpinn.PINNConfig(hidden=hidden, mode=mode, tt_rank=2, tt_L=3,
                           pde="hjb-20d", deriv="fd_fast",
                           use_fused_kernel=True,
                           noise=JNoise(enabled=mode in ("tonn", "onn")))
    jm = jpinn.TensorPinn(cfg)
    key = jax.random.PRNGKey(3)
    params = jm.init(key)
    hw = jm.sample_noise(jax.random.fold_in(key, 99))
    xt = _points(LOSS_BATCH, jm.net_in, seed=5)
    w = np.random.RandomState(6).standard_normal(LOSS_BATCH).astype(
        np.float32)
    return cfg, jm, params, hw, xt, w


def _port_grads(tm, params, hw, fn):
    tp = zoo.tree_map(lambda t: t.requires_grad_(),
                      interop.params_from_numpy(_np_tree(params), "cpu"))
    out = fn(tm, tp, interop.noise_from_numpy(_np_tree(hw), "cpu"))
    return out, torch.autograd.grad(out, zoo.tree_leaves(tp))


@pytest.mark.parametrize("mode,hidden", [("dense", 64), ("tt", 64),
                                         ("tonn", 64), ("onn", 64),
                                         ("onn", 144)])
def test_bp_gradients_match_jax(mode, hidden):
    """Autograd of the port's forward against ``jax.grad`` of JAX's: the
    u-level functional strictly, the residual loss at the FD floor; onn
    also at hidden 144, whose hidden meshes take the warp-rows backward
    on the card."""
    cfg, jm, params, hw, xt, w = _grad_setup(mode, hidden)
    # the u functional through JAX's unfused model (libm sin, the chain)
    ju = jpinn.TensorPinn(jpinn.PINNConfig(**{
        **jpinn.config_to_meta(cfg), "use_fused_kernel": False,
        "noise": cfg.noise, "quant": cfg.quant}))
    # jitted whole: the meshes' and chains' scans op by op take ~10x longer
    want_u = jax.jit(jax.grad(
        lambda p: jnp.sum(ju.u(p, jnp.asarray(xt), hw) * w)))(params)
    tm = _port_model(cfg)
    _, got_u = _port_grads(tm, params, hw, lambda m, p, nz: torch.sum(
        m.u(p, torch.tensor(xt), nz) * torch.tensor(w)))
    for got, want in zip(got_u, jax.tree.leaves(_np_tree(want_u))):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max() + 1e-9)

    loss_j, want_l = jax.jit(jax.value_and_grad(
        lambda p: jpinn.residual_loss(jm, p, jnp.asarray(xt), hw)))(params)
    loss, got_l = _port_grads(tm, params, hw, lambda m, p, nz:
                              tpinn.residual_loss(m, p, torch.tensor(xt), nz))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=2.5e-1)
    g = np.concatenate([t.numpy().ravel() for t in got_l])
    gj = np.concatenate([np.ravel(t) for t in jax.tree.leaves(
        _np_tree(want_l))])
    assert np.isfinite(g).all()
    assert np.linalg.norm(g - gj) <= 2.5e-1 * np.linalg.norm(gj)


@pytest.mark.parametrize("mode", ["tonn", "onn"])
def test_bp_steps_never_call_prepare_params_plain(monkeypatch, mode):
    """The trainer's BP step and Table 1's densify tonn through
    ``prepare_params`` (on the card one grouped launch forward and one
    backward), never the plain oracle ``prepare_params_plain``; onn BP at
    hidden 64 steps too.  Both steps move every trainable leaf."""
    from benchmarks import torch_table1_hjb as ttable

    def refuse(*args, **kwargs):
        raise AssertionError("the BP step called prepare_params_plain")

    monkeypatch.setattr(tpinn.TensorPinn, "prepare_params_plain", refuse)
    cfg, jm, params, hw, xt, _ = _grad_setup(mode)
    tm = _port_model(cfg)
    tparams = interop.params_from_numpy(_np_tree(params), "cpu")
    noise = interop.noise_from_numpy(_np_tree(hw), "cpu")
    mask = tm.trainable_mask(tparams)
    opt = get_optimizer("adamw", lr=1e-2)
    step = train._bp_step_fn(tm, opt, mask, noise)
    new, _, loss = step(tparams, opt.init(tparams), torch.tensor(xt), {})
    table, tloss = ttable._bp_step(tm, tparams, mask, torch.tensor(xt), {},
                                   1e-2)
    assert torch.isfinite(loss) and torch.isfinite(tloss)
    for moved in (new, table):
        for a, b, m in zip(zoo.tree_leaves(moved), zoo.tree_leaves(tparams),
                           zoo.tree_leaves(mask)):
            assert not m or not torch.equal(a, b)


def test_adamw_moves_the_fixed_diags_as_jax_does():
    """One BP step of tonn with AdamW in both packages: the ±1 diag
    buffers get no gradient, but the decoupled weight decay shrinks them
    by lr·0.1 in both, to the same values."""
    cfg, jm, params, hw, xt, _ = _grad_setup("tonn")
    mask = jm.trainable_mask(params)
    jo = jopt.adamw(lr=1e-2)
    grads = jax.grad(lambda p: jpinn.residual_loss(
        jm, p, jnp.asarray(xt), hw))(params)
    grads = jax.tree.map(lambda g, t: g if t else jnp.zeros_like(g), grads,
                         mask)
    jnew, _ = jo.update(grads, jo.init(params), params)

    tm = _port_model(cfg)
    tparams = interop.params_from_numpy(_np_tree(params), "cpu")
    opt = get_optimizer("adamw", lr=1e-2)
    step = train._bp_step_fn(tm, opt, tm.trainable_mask(tparams),
                             interop.noise_from_numpy(_np_tree(hw), "cpu"))
    new, state, loss = step(tparams, opt.init(tparams), torch.tensor(xt), {})
    assert int(state["count"]) == 1 and torch.isfinite(loss)
    moved = 0
    for got, want, old, train_ in zip(
            zoo.tree_leaves(new), jax.tree.leaves(_np_tree(jnew)),
            zoo.tree_leaves(tparams), jax.tree.leaves(mask)):
        if train_:
            continue
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), old.numpy() * (1 - 1e-3),
                                   rtol=1e-6)
        moved += 1
    assert moved == 2 * 3 * 2              # diag_u, diag_v of 6 meshes x 2


# ----------------------------------------------------------------- the CLI

REDUCED = ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--reduced",
           "--device", "cpu", "--log-every", "100", "--batch", "8"]


def _run(*extra):
    return train.main(REDUCED + [str(a) for a in extra])


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_bp_cli_checkpoints_for_jax_and_resumes(tmp_path, name):
    """Each optimizer trains tt at the reduced size; its checkpoint's
    ``params`` and ``opt`` subtrees restore in JAX against JAX's own
    trees; a run cut after step_3 resumes into the uninterrupted one."""
    args = ("--pinn-mode", "tt", "--optimizer", name, "--steps", 6,
            "--ckpt-dir", tmp_path, "--ckpt-every", 3)
    full = _run(*args)
    assert len(full.losses) == 6 and np.isfinite(full.losses).all()
    assert np.isfinite(full.val_mse)
    meta = read_checkpoint_meta(tmp_path)
    assert meta["step"] == 6 and meta["seed"] == 0
    assert any(k.startswith("opt/") for k in meta["keys"])
    jm = jpinn.TensorPinn(jpinn.config_from_meta(meta["pinn"]))
    like = jm.init(jax.random.PRNGKey(0))
    jo = jopt.get_optimizer(name)
    restored, _ = jax_restore(tmp_path, {"params": like,
                                         "opt": jo.init(like)})
    for got, want in zip(jax.tree.leaves(restored["params"]),
                         zoo.tree_leaves(full.params)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    # JAX continues from the port's state: one more update runs
    jax_params, jax_state = jo.update(
        jax.tree.map(jnp.zeros_like, restored["params"]), restored["opt"],
        restored["params"])
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(jax_params))
    if name != "sgd":
        assert int(restored["opt"]["count"]) == 6
        assert restored["opt"]["count"].dtype == jnp.int32

    shutil.rmtree(tmp_path / "step_000000000006")          # the cut
    resumed = _run(*args, "--resume")
    assert resumed.losses == full.losses[3:]
    for a, b in zip(zoo.tree_leaves(resumed.params),
                    zoo.tree_leaves(full.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("extra", [
    ("--pinn-mode", "dense", "--optimizer", "sgd"),
    ("--pinn-mode", "tonn", "--pinn-noise", "--optimizer", "adamw"),
    ("--pinn-mode", "tonn", "--pinn-noise", "--sequential"),
    ("--pinn-mode", "dense")])
def test_cli_trains_the_new_paths(extra, capsys):
    """The BP baselines in dense and tonn (noise on), the sequential ZO
    path and dense ZO: finite losses and val MSE; the sequential path runs
    the plain FD stencil, not the fused one."""
    res = _run("--steps", 4, *extra)
    assert len(res.losses) == 4 and np.isfinite(res.losses).all()
    assert np.isfinite(res.val_mse)
    out = capsys.readouterr().out
    if "--sequential" in extra:
        assert "deriv=fd " in out and "fused=False" in out
    else:
        assert "deriv=fd_fast" in out
