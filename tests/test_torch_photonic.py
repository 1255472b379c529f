"""The port's MZI-mesh simulator against the JAX package's.

Phases, diagonals, inputs and noise are made with numpy from a seed (or, for
the noise case, sampled by JAX) and handed to both packages.  Tolerance for
mesh outputs: ``rtol=1e-5, atol=1e-5`` — the same f32 rotations level by
level, with sin/cos from two libraries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import photonic as jph
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import photonic as tph

RTOL = ATOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("ports", [1, 2, 3, 4, 8, 16, 33])
def test_rectangular_layout_and_gather_plan_equal(ports):
    jl, tl = jph.rectangular_layout(ports), tph.rectangular_layout(ports)
    assert tl.ports == jl.ports
    for field in ("idx_a", "idx_b", "mask"):
        np.testing.assert_array_equal(getattr(tl, field), getattr(jl, field))
    assert tl.num_mzis == jl.num_mzis == ports * (ports - 1) // 2
    for a, b in zip(tph.mesh_gather_plan(tl), jph.mesh_gather_plan(jl)):
        np.testing.assert_array_equal(a, b)


def test_rectangular_layout_is_schedule_ops_of_its_columns():
    """The closed-form rectangular layout is the one ``schedule_ops`` makes
    of its columns' pairs (a, a+1), a ≡ c mod 2, in order — field for
    field, dtypes included — at every width up to 64 and at 137 and 1024
    ports (against the JAX package's too), and its gather plan is the
    JAX package's."""
    for ports in [*range(1, 65), 137, 1024]:
        ops = [(a, a + 1) for c in range(ports)
               for a in range(c % 2, ports - 1, 2)]
        want = tph.schedule_ops(ports, ops) if ports <= 137 else \
            jph.rectangular_layout(ports)
        got = tph.rectangular_layout(ports)
        assert got.ports == want.ports
        for field in ("idx_a", "idx_b", "mask"):
            a, b = getattr(got, field), np.asarray(getattr(want, field))
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for ports in (137, 1024):
        jl = jph.rectangular_layout(ports)
        for a, b in zip(tph.mesh_gather_plan(tph.rectangular_layout(ports)),
                        jph.mesh_gather_plan(jl)):
            np.testing.assert_array_equal(a, b)


def test_schedule_ops_equal_on_an_irregular_rotation_list():
    ops = [(0, 1), (2, 3), (1, 2), (0, 1), (3, 4), (2, 3), (1, 2)]
    jl, tl = jph.schedule_ops(5, ops), tph.schedule_ops(5, ops)
    for field in ("idx_a", "idx_b", "mask"):
        np.testing.assert_array_equal(getattr(tl, field), getattr(jl, field))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("ports", [4, 8, 16])
def test_mesh_apply_matches_jax(ports, transpose):
    rng = np.random.RandomState(ports + transpose)
    layout_j = jph.rectangular_layout(ports)
    layout_t = tph.rectangular_layout(ports)
    phases = rng.uniform(-np.pi, np.pi, layout_j.phase_shape()).astype(
        np.float32)
    diag = rng.choice([-1.0, 1.0], ports).astype(np.float32)
    x = rng.standard_normal((2, 5, ports)).astype(np.float32)
    y_jax = np.asarray(jph.mesh_apply(layout_j, jnp.asarray(phases),
                                      jnp.asarray(diag), jnp.asarray(x),
                                      transpose=transpose))
    y = tph.mesh_apply(layout_t, torch.tensor(phases), torch.tensor(diag),
                       torch.tensor(x), transpose=transpose)
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=RTOL, atol=ATOL)
    cos_j, sin_j = jph.mesh_gather_tables(layout_j, jnp.asarray(phases),
                                          transpose)
    cos_t, sin_t = tph.mesh_gather_tables(layout_t, torch.tensor(phases),
                                          transpose)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_one_level_mesh_matches_jax(transpose):
    """A 2-port mesh has a single level: its level-reversed perm table (a
    negative-stride view) must still reach torch, as in a tonn core whose
    unfolding is 2 wide."""
    layout_j, layout_t = jph.rectangular_layout(2), tph.rectangular_layout(2)
    assert layout_t.levels == 1
    phases = np.asarray([[0.7]], np.float32)
    x = np.random.RandomState(1).standard_normal((3, 2)).astype(np.float32)
    diag = np.asarray([1.0, -1.0], np.float32)
    y = tph.mesh_apply(layout_t, torch.tensor(phases), torch.tensor(diag),
                       torch.tensor(x), transpose=transpose)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jph.mesh_apply(
            layout_j, jnp.asarray(phases), jnp.asarray(diag), jnp.asarray(x),
            transpose=transpose)), rtol=RTOL, atol=ATOL)


def test_effective_phases_match_jax():
    rng = np.random.RandomState(0)
    phases = rng.standard_normal((6, 4)).astype(np.float32)
    noise = {"gamma": (1.0 + 0.01 * rng.standard_normal((6, 4))).astype(
        np.float32),
             "bias": rng.uniform(0, 2 * np.pi, (6, 4)).astype(np.float32)}
    for kw in ({}, {"crosstalk": 0.0}, {"enabled": False}):
        jm, tm = jph.NoiseModel(**kw), tph.NoiseModel(**kw)
        got = tm.effective_phases(torch.tensor(phases),
                                  interop.noise_from_numpy(noise, "cpu"))
        want = jm.effective_phases(jnp.asarray(phases),
                                   jax.tree.map(jnp.asarray, noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def test_noise_sample_shapes_and_ranges():
    model = tph.NoiseModel(enabled=True)
    a = model.sample(torch.Generator().manual_seed(1), (7, 3))
    b = model.sample(torch.Generator().manual_seed(1), (7, 3))
    assert set(a) == {"gamma", "bias"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["gamma"].dtype == a["bias"].dtype == torch.float32
    assert 0.0 <= float(a["bias"].min()) and float(a["bias"].max()) < 2 * np.pi
    off = tph.NoiseModel(enabled=False).sample(None, (2, 2))
    assert torch.equal(off["gamma"], torch.ones(2, 2))
    assert torch.equal(off["bias"], torch.zeros(2, 2))


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("out_dim,in_dim", [(8, 8), (4, 16), (16, 8)])
def test_photonic_matrix_to_dense_matches_jax(out_dim, in_dim, noisy):
    jm = jph.PhotonicMatrix(out_dim, in_dim)
    tm = tph.PhotonicMatrix(out_dim, in_dim)
    params = _np_tree(jm.init(jax.random.PRNGKey(out_dim * in_dim)))
    model_j, model_t, noise = None, None, None
    if noisy:
        model_j, model_t = jph.NoiseModel(), tph.NoiseModel()
        noise = _np_tree(jm.sample_noise(jax.random.PRNGKey(7), model_j))
    w_jax = np.asarray(jm.to_dense(jax.tree.map(jnp.asarray, params),
                                   model_j, noise and jax.tree.map(
                                       jnp.asarray, noise)))
    w = tm.to_dense(interop.params_from_numpy(params, "cpu"), model_t,
                    interop.noise_from_numpy(noise, "cpu"))
    assert tuple(w.shape) == (out_dim, in_dim)
    np.testing.assert_allclose(w.numpy(), w_jax, rtol=RTOL, atol=ATOL)
    # to_dense is apply on the identity: W x == apply(x)
    x = np.random.RandomState(1).standard_normal((3, in_dim)).astype(
        np.float32)
    y = tm.apply(interop.params_from_numpy(params, "cpu"), torch.tensor(x),
                 model_t, interop.noise_from_numpy(noise, "cpu"))
    np.testing.assert_allclose(y.numpy(), x @ w_jax.T, rtol=RTOL, atol=ATOL)


def test_photonic_matrix_init_tree_matches_jax():
    """Same keys, shapes and dtypes as the JAX params tree, so a JAX tree
    converts leaf for leaf and a checkpoint restores into it."""
    jm, tm = jph.PhotonicMatrix(16, 8), tph.PhotonicMatrix(16, 8)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.init(torch.Generator().manual_seed(0))
    assert set(tp) == set(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
        assert tp[k].dtype == torch.float32
    jn = jm.sample_noise(jax.random.PRNGKey(1), jph.NoiseModel())
    tn = tm.sample_noise(torch.Generator().manual_seed(1), tph.NoiseModel())
    assert jax.tree.map(np.shape, jn) == jax.tree.map(
        lambda t: tuple(t.shape), tn)


# ---------------------------------------------- stacked meshes (ZO training)

def _stack_inputs(ports, S, B, shared, stacked_diag, seed):
    rng = np.random.RandomState(seed)
    layout = jph.rectangular_layout(ports)
    phases = rng.uniform(-np.pi, np.pi, (S, *layout.phase_shape())).astype(
        np.float32)
    diag = rng.choice([-1.0, 1.0], (S, ports) if stacked_diag else ports)
    x = rng.standard_normal((B, ports) if shared else (S, B, ports))
    return phases, diag.astype(np.float32), x.astype(np.float32)


@pytest.mark.parametrize("stacked_diag", [False, True])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("ports", [4, 7, 16])
def test_mesh_apply_stacked_matches_jax(ports, transpose, shared,
                                        stacked_diag):
    """The plain stacked mesh against JAX's plain version and its Pallas
    kernel body in interpret mode (atol 1e-6: unit-norm rotations of O(1)
    inputs, sin/cos from two libraries)."""
    S, B = 3, 5
    phases, diag, x = _stack_inputs(ports, S, B, shared, stacked_diag,
                                    seed=ports + 2 * transpose + shared)
    args = (jnp.asarray(phases), jnp.asarray(diag), jnp.asarray(x))
    layout_j = jph.rectangular_layout(ports)
    y = tph.mesh_apply_stacked(tph.rectangular_layout(ports),
                               torch.tensor(phases), torch.tensor(diag),
                               torch.tensor(x), transpose=transpose)
    assert tuple(y.shape) == (S, B, ports)
    for want in (jph.mesh_apply_stacked(layout_j, *args, transpose=transpose),
                 jops.mesh_apply_stacked(layout_j, *args, transpose=transpose,
                                         mode="interpret")):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=1e-6)


def test_stack_axes_reach_the_tables_and_the_gather_core():
    """Rank-agnostic ``mesh_gather_tables`` and ``mesh_apply``: 3-D phases,
    a (S, P) diag and (S, B, P) inputs give the JAX package's tables and
    its stacked mesh, entry by entry."""
    ports, S = 8, 4
    phases, diag, x = _stack_inputs(ports, S, 6, False, True, seed=11)
    layout_j, layout_t = jph.rectangular_layout(ports), tph.rectangular_layout(
        ports)
    for transpose in (False, True):
        tables_j = jph.mesh_gather_tables(layout_j, jnp.asarray(phases),
                                          transpose)
        tables_t = tph.mesh_gather_tables(layout_t, torch.tensor(phases),
                                          transpose)
        for got, want in zip(tables_t, tables_j):
            assert tuple(got.shape) == (S, layout_t.levels, ports)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=1e-6)
        y = tph.mesh_apply(layout_t, torch.tensor(phases), torch.tensor(diag),
                           torch.tensor(x), transpose=transpose)
        for s in range(S):
            want = jph.mesh_apply(layout_j, jnp.asarray(phases[s]),
                                  jnp.asarray(diag[s]), jnp.asarray(x[s]),
                                  transpose=transpose)
            np.testing.assert_allclose(y[s].numpy(), np.asarray(want),
                                       rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("out_dim,in_dim", [(4, 16), (16, 4), (7, 5)])
def test_to_dense_stacked_matches_jax(out_dim, in_dim, noisy):
    """S stacked parameter sets densify in one pass, the chip's noise
    shared across the stack, as JAX's ``to_dense_stacked`` does."""
    S = 3
    jm, tm = jph.PhotonicMatrix(out_dim, in_dim), tph.PhotonicMatrix(
        out_dim, in_dim)
    per = [jm.init(jax.random.PRNGKey(s)) for s in range(S)]
    stacked = {k: np.stack([np.asarray(p[k]) for p in per]) for k in per[0]}
    model_j, model_t, noise = None, None, None
    if noisy:
        model_j, model_t = jph.NoiseModel(), tph.NoiseModel()
        noise = _np_tree(jm.sample_noise(jax.random.PRNGKey(7), model_j))
    want = np.asarray(jm.to_dense_stacked(
        jax.tree.map(jnp.asarray, stacked), model_j,
        noise and jax.tree.map(jnp.asarray, noise)))
    got = tm.to_dense_stacked(interop.params_from_numpy(stacked, "cpu"),
                              model_t, interop.noise_from_numpy(noise, "cpu"))
    assert tuple(got.shape) == (S, out_dim, in_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    # entry s is the single densification of the s-th params
    single = tm.to_dense(interop.params_from_numpy(
        {k: v[1] for k, v in stacked.items()}, "cpu"), model_t,
        interop.noise_from_numpy(noise, "cpu"))
    np.testing.assert_allclose(got[1].numpy(), single.numpy(), rtol=RTOL,
                               atol=1e-6)


def test_buffer_keys_and_plan_tensors():
    """The gather plan on a device, memoized on the layout: the kernel's
    int32 perm tables in application order, transposed reversed."""
    assert tph.PHOTONIC_BUFFER_KEYS == jph.PHOTONIC_BUFFER_KEYS
    layout = tph.rectangular_layout(6)
    perm, slot, sign = tph.mesh_gather_plan(layout)
    plan = tph.mesh_plan_tensors(layout, torch.device("cpu"))
    assert plan is tph.mesh_plan_tensors(layout, torch.device("cpu"))
    np.testing.assert_array_equal(plan["perm"].numpy(), perm)
    np.testing.assert_array_equal(plan["perm_t"].numpy(), perm[::-1])
    np.testing.assert_array_equal(plan["slot"].numpy(), slot)
    np.testing.assert_array_equal(plan["sign"].numpy(), sign)
    assert plan["perm"].dtype == plan["perm_t"].dtype == torch.int32
    assert plan["perm_t"].is_contiguous()


def test_mesh_kernel_wrapper_refuses_what_it_cannot_take():
    """On the CPU the dispatcher takes the plain version; the kernel
    wrapper itself raises for a non-CUDA tensor, and its shared-memory
    limit refuses the wide onn meshes before any launch."""
    from repro_torch.kernels import mesh_apply as tmesh
    from repro_torch.kernels import ops as tops
    layout = tph.rectangular_layout(4)
    phases = torch.zeros((2, *layout.phase_shape()))
    before = tmesh.mesh_apply_stacked.launches
    tops.mesh_apply_stacked(layout, phases, torch.ones(4), torch.ones(3, 4))
    assert tmesh.mesh_apply_stacked.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tmesh.mesh_apply_stacked(layout, phases, torch.ones(4),
                                 torch.ones(3, 4))
    assert tmesh.rows_per_block(tph.rectangular_layout(16)) == 64
    assert tmesh.smem_bytes(138, 138, 1) <= tmesh.SMEM_MAX_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        tmesh.rows_per_block(tph.rectangular_layout(139))
