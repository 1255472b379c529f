"""Distributed ZO of the port (``repro_torch.parallel.zo_shard``) on the
CPU: one 8-rank ``gloo`` world, spawned once for the module, runs every
case (``torch_dist_ranks.world_cases``); the tests hold its results to the
single-rank fused ``zoo.spsa_gradient`` and to the JAX package's.

The counterpart of ``tests/test_distribution.py``'s distributed-ZO cases
(which run JAX's ``shard_map`` on 8 forced host devices): the masked-loss
protocol, gradient identity on the 8 layouts for a quadratic loss and the
tonn PINN (hjb-10d, hidden 32, batch 64, N = 6) at the JAX test's
tolerances, the PINN also on JAX's ξ (its draws carried over as numpy)
against JAX's single-device gradient, scalar-only traffic measured over
every collective, and an elastic 8 → 4 resume.  Then the trainer's
``--shard`` on 2 ranks against the unsharded run.

Across the packages the FD residual's losses agree only at the FD floor:
u agrees to f32 rounding, but the stencil's second differences amplify
that by 1/h² = 1e4, and the losses of one ξ stack differ by 0.2–1.5%
(hjb-10d here, the seven entries of JAX's ξ stack) while the SPSA deltas
L_i − L_0 are 1–3% of L, so the two packages' FD gradients differ by
10–40%.  On JAX's ξ the port's layouts
are therefore held to JAX's gradient through a u-level loss of the same
tonn PINN (the same stacked chain and densification, no stencil) at the
JAX test's tolerances; with the residual loss, to the port's single-rank
gradient on JAX's ξ at those tolerances and to JAX's base loss at the FD
floor: 2e-2, just above that 1.5% (the base itself differs by 0.024%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.core import pinn as jpinn
from repro.core import zoo as jzoo
from repro_torch import interop
from repro_torch.core import zoo as tzoo
from repro_torch.device import counter_generator
from repro_torch.launch import train
from repro_torch.optim import zo_signsgd_trainer_step
from repro_torch.parallel import zo_shard
from test_torch_pinn import share_cores  # noqa: F401 (autouse)

WORLD = 8
LAYOUT_IDS = [spec for spec, _ in ranks.ZO_LAYOUTS]


N = 6
# batch 64 keeps ≥ 8 collocation points a rank on the 8-way batch axis
JAX_CFG = jpinn.PINNConfig(hidden=32, mode="tonn", tt_L=3, pde="hjb-10d",
                           deriv="fd_fast", use_fused_kernel=True)


def _jax_side(model, key):
    """The JAX package's params, batch and ξ of the PINN case, its
    single-device fused gradient and base loss of the u-level loss on that
    ξ, and its FD residual's base loss — one jitted program."""
    params = model.init(key)
    xt = model.problem.sample_collocation(jax.random.fold_in(key, 1), 64)
    sub = jax.random.fold_in(key, 2)
    mask = model.trainable_mask(params)
    cfg = jzoo.SPSAConfig(num_samples=N, mu=1e-2)
    xis = jzoo.sample_perturbations(sub, params, N, mask)

    def u_blf(sp):
        u = model.u_stacked(model.prepare_params_stacked(sp, None), xt)
        return jnp.mean((u - jnp.mean(xt, axis=-1)) ** 2, axis=-1)

    # the same ξ: spsa_gradient draws it from ``sub`` inside
    g, base = jzoo.spsa_gradient(None, params, sub, cfg,
                                 batched_loss_fn=u_blf, trainable_mask=mask)
    fd_base = jpinn.residual_losses_stacked(
        model, jax.tree.map(lambda a: a[None], params), xt)[0]
    return params, xt, xis, g, base, fd_base


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX side's arrays, the 8-rank world's results, and the
    single-rank references."""
    jmodel = jpinn.TensorPinn(JAX_CFG)
    jparams, jxt, jxis, jug, jubase, jfd_base = jax.tree.map(
        np.asarray, jax.jit(lambda k: _jax_side(jmodel, k))(
            jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    inputs = {
        "pinn_meta": jpinn.config_to_meta(jmodel.cfg),
        "pinn_params": jparams, "pinn_xt": jxt, "pinn_n": N,
        "pinn_jax_xis": jxis,
        "quad_target": rs.randn(16).astype(np.float32),
        "quad_xt": np.random.RandomState(5).randn(16, 4).astype(np.float32),
        "mask_target": np.random.RandomState(0).randn(16).astype(np.float32),
        "ckpt_dir": str(tmp_path_factory.mktemp("elastic")),
    }
    results = zo_shard.run_ranks(ranks.world_cases, WORLD, inputs,
                                 device="cpu")

    # the single-rank fused references of the port
    tmodel, tparams, txt, tcfg, tblf = ranks.pinn_setup(inputs)
    tmask = tmodel.trainable_mask(tparams)
    with torch.no_grad():
        g_pinn, base_pinn = tzoo.spsa_gradient(
            tparams, counter_generator(ranks.PINN_SEED), tcfg,
            lambda sp: tblf(sp, txt), tmask)
        g_jxi, base_jxi = tzoo.spsa_gradient(
            tparams, None, tcfg, lambda sp: tblf(sp, txt), tmask,
            xis=interop.params_from_numpy(inputs["pinn_jax_xis"], "cpu"))
        target = torch.tensor(inputs["quad_target"])
        qxt = torch.tensor(inputs["quad_xt"])
        g_quad, base_quad = tzoo.spsa_gradient(
            {"w": torch.zeros(16)}, counter_generator(ranks.QUAD_SEED),
            tzoo.SPSAConfig(num_samples=6, mu=1e-2),
            lambda sp: ranks.quad_batched_loss(target)(sp, qxt))
    return {"inputs": inputs, "results": results,
            "pinn": (ranks.numpy_tree(g_pinn), float(base_pinn)),
            "pinn_jax_xis": (ranks.numpy_tree(g_jxi), float(base_jxi)),
            "quad": (g_quad["w"].numpy(), float(base_quad)),
            "jax_fd_base": float(jfd_base),
            "jax_u": (jug, float(jubase))}


def _pinn_close(got, want, base_got, base_want, label):
    got_l, want_l = tzoo.tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    scale = max(float(np.max(np.abs(w))) for w in want_l)
    for a, b in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, atol=1e-4 * scale, rtol=1e-3,
                                   err_msg=label)
    np.testing.assert_allclose(base_got, base_want, rtol=1e-4, err_msg=label)


def _members(world, spec):
    return [r["layouts"][spec] for r in world["results"]
            if spec in r["layouts"]]


def test_masked_loss_protocol(world):
    """Each rank keeps its own index of the N losses, one all_reduce of
    the N-vector merges them: the single-rank gradient, on every rank.  The
    index-shard hook leaves zeros outside a rank's slice, and
    ``zo_signsgd_trainer_step`` over 8 workers gives the one-worker
    update."""
    inputs = world["inputs"]
    target = torch.tensor(inputs["mask_target"])
    loss_fn = ranks.quad_loss(target)
    params = {"w": torch.zeros(16)}
    cfg = tzoo.SPSAConfig(num_samples=WORLD, mu=1e-2)
    g_ref, base_ref = tzoo.spsa_gradient(
        params, counter_generator(ranks.QUAD_SEED), cfg, loss_fn=loss_fn)
    want_p, want_loss = zo_signsgd_trainer_step(
        loss_fn, params, counter_generator(ranks.QUAD_SEED), 1e-3,
        num_samples=WORLD)
    full = tzoo.spsa_losses(loss_fn, params,
                            counter_generator(ranks.QUAD_SEED), cfg)
    for r in world["results"]:
        m = r["masked"]
        np.testing.assert_allclose(m["grad"], g_ref["w"].numpy(), rtol=1e-5)
        sliced = np.zeros(WORLD, np.float32)
        sliced[r["rank"]] = full[r["rank"]]
        np.testing.assert_array_equal(m["sliced"], sliced)
        np.testing.assert_array_equal(m["trainer_params"],
                                      want_p["w"].numpy())
        assert m["trainer_loss"] == float(want_loss) == float(base_ref)


@pytest.mark.parametrize("spec", LAYOUT_IDS)
def test_zo_shard_gradient_identity_quadratic(world, spec):
    """Every layout reproduces the single-rank fused gradient (batch
    sharding: the batch mean reassociated), on each of its ranks."""
    g_ref, base_ref = world["quad"]
    rows = _members(world, spec)
    p, b = (int(v) for v in spec.split("x"))
    assert len(rows) == p * b
    assert sorted(r["position"] for r in rows) == [
        (i, j) for i in range(p) for j in range(b)]
    for row in rows:
        g, base = row["quad"]
        np.testing.assert_allclose(g, g_ref, rtol=1e-4,
                                   atol=1e-4 * float(np.max(np.abs(g_ref))),
                                   err_msg=spec)
        np.testing.assert_allclose(base, base_ref, rtol=1e-5, err_msg=spec)


@pytest.mark.parametrize("spec", LAYOUT_IDS)
def test_zo_shard_gradient_identity_pinn(world, spec):
    """The tonn PINN's fused stacked evaluator through every layout
    against the single-rank fused gradient of the same ξ, at the JAX
    test's tolerances (loss-level f32 reassociation passes linearly into
    the reconstruction); every rank of a layout holds the same bits."""
    g_ref, base_ref = world["pinn"]
    rows = _members(world, spec)
    for row in rows:
        g, base = row["pinn"]
        _pinn_close(g, g_ref, base, base_ref, spec)
        for a, b in zip(tzoo.tree_leaves(g),
                        tzoo.tree_leaves(rows[0]["pinn"][0])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", LAYOUT_IDS)
def test_zo_shard_pinn_matches_jax_on_the_same_xi(world, spec):
    """Fed JAX's ξ, every layout of the port gives the JAX package's
    single-device fused gradient and base loss of the tonn PINN's u-level
    loss at the JAX test's tolerances; with the FD residual, the port's
    single-rank gradient on that ξ at those tolerances, and JAX's base
    loss at the FD floor (2e-2; module docstring)."""
    g_u, base_u = world["jax_u"]
    g_res, base_res = world["pinn_jax_xis"]
    for row in _members(world, spec):
        g, base = row["pinn_u_jax_xis"]
        _pinn_close(g, g_u, base, base_u, f"{spec} vs JAX, u-level loss")
        g, base = row["pinn_jax_xis"]
        _pinn_close(g, g_res, base, base_res, f"{spec}, JAX's ξ")
        np.testing.assert_allclose(base, world["jax_fd_base"], rtol=2e-2,
                                   err_msg=f"{spec} vs JAX, FD floor")


def test_zo_shard_traffic_is_scalar_only(world):
    """One distributed step on 4x2 moves O(N) f32 scalars a rank, counted
    over every collective it issues — never a parameter-sized tensor."""
    n = world["inputs"]["pinn_n"]
    bound = zo_shard.wire_bound_bytes(n, 4)
    for r in world["results"]:
        t = r["traffic"]
        assert t["bytes"] > 0, t
        assert t["bytes"] <= bound, t
        assert t["bytes"] < t["param_bytes"], t
        assert {op for op, _, _ in t["ops"]} == {"all_reduce"}, t
        # any collective counts: a tensor's bytes, an object's pickle
        other = t["others"]
        assert other[:2] == [("all_reduce", [(3,)], 12),
                             ("broadcast", [(5,)], 40)], other
        assert {op for op, _, _ in other[2:]} == {"all_gather"}, other
        assert sum(b for _, _, b in other[2:]) > 0, other
        assert t["gathered"] == [{"rank": i} for i in range(WORLD)]


def test_zo_shard_elastic_resize_8_to_4(world):
    """Checkpoint on 8 ranks, resume on 4: the losses and params continue
    the uninterrupted 8-rank run."""
    rows = [r["elastic"] for r in world["results"]]
    assert all(e["meta_step"] == 2 and e["pert4"] == 4 for e in rows)
    assert [e["member4"] for e in rows] == [True] * 4 + [False] * 4
    for e in rows[:4]:
        np.testing.assert_allclose(e["losses4"], e["losses8"][2:], rtol=1e-6)
        assert e["step4"] == 5
        for a, b in zip(tzoo.tree_leaves(e["params4"]),
                        tzoo.tree_leaves(e["params_ref"])):
            np.testing.assert_allclose(a, b, atol=1e-7)


def test_make_zo_mesh_parsing_without_a_world():
    """The JAX package's parsing and errors; without a process group only
    the one-rank layout exists."""
    mesh = zo_shard.make_zo_mesh()
    assert mesh.shape == {"pert": 1, "batch": 1} and mesh.member
    assert (mesh.pert_index, mesh.batch_index) == (0, 0)
    assert zo_shard.make_zo_mesh("1x1", "both").axis_names == ("pert",
                                                               "batch")
    with pytest.raises(ValueError, match="contradicts"):
        zo_shard.make_zo_mesh("2x2", "perturbation")
    with pytest.raises(ValueError, match="contradicts"):
        zo_shard.make_zo_mesh("2x2", "batch")
    with pytest.raises(ValueError, match="unknown shard mode"):
        zo_shard.make_zo_mesh("1x1", "rows")
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        zo_shard.mesh_shape("2x2", "both", 2)
    assert zo_shard.mesh_shape(None, "both", 8) == (4, 2)
    assert zo_shard.mesh_shape("3", "batch", 4) == (1, 3)
    with pytest.raises(ValueError, match="initialized process group"):
        zo_shard.make_zo_mesh("2x1", "perturbation", ranks=[0, 1])
    assert [zo_shard.pert_shard_size(7, s) for s in (1, 2, 4, 8)] == \
        [7, 4, 2, 2]
    assert zo_shard.wire_bound_bytes(6, 4) == 4 * (8 + 2 + 4)


def test_the_launcher_defaults_to_the_card():
    """The device rule: ``run_ranks`` asks for ``cuda`` unless told, and
    without a card it raises before any rank starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zo_shard.run_ranks(ranks.failing_rank, 2)


def test_a_failing_rank_fails_the_launch():
    """No rank's failure is passed over: the launcher raises (with rank
    1's error, or with rank 0's when its barrier breaks first)."""
    import torch.multiprocessing as mp
    with pytest.raises((mp.ProcessRaisedException, mp.ProcessExitedException)):
        zo_shard.run_ranks(ranks.failing_rank, 2, device="cpu")


CLI = ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--reduced",
       "--pinn-noise", "--steps", "4", "--batch", "16", "--log-every", "2",
       "--device", "cpu"]


@pytest.mark.parametrize("flags", [[], ["--quant", "int8", "--phase-bits",
                                         "8"]], ids=["f32", "qat"])
def test_cli_shard_perturbation_matches_the_unsharded_run(flags):
    """``--shard perturbation --mesh 2x1`` (2 spawned ranks) trains as the
    unsharded run: the same losses (rtol 1e-5) and params; QAT composes,
    its fake quantization inside each rank's losses."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)           # as each rank runs
    try:
        ref = train.main(CLI + flags)
    finally:
        torch.set_num_threads(threads)
    got = train.main(CLI + flags + ["--shard", "perturbation", "--mesh",
                                    "2x1"])
    assert [r["rank"] for r in got.ranks] == [0, 1]
    assert all(r["losses"] == got.losses for r in got.ranks)
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-5)
    for a, b in zip(tzoo.tree_leaves(got.params), tzoo.tree_leaves(ref.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert got.val_mse == pytest.approx(ref.val_mse, rel=1e-4)


@pytest.mark.parametrize("flags, message", [
    (["--shard", "perturbation", "--optimizer", "adamw"],
     "--shard is distributed ZO only"),
    (["--shard", "perturbation", "--sequential"],
     "--shard needs the stacked evaluator"),
    (["--shard", "batch", "--mesh", "1x3"], "not divisible by the 3-way"),
    (["--shard", "perturbation", "--mesh", "2x2"], "contradicts"),
])
def test_cli_shard_exits(flags, message):
    """The JAX trainer's exits, before any rank is spawned."""
    with pytest.raises(SystemExit, match=message):
        train.main(CLI + flags)
