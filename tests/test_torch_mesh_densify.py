"""The grouped densification of a model's core meshes
(``photonic.mesh_densify_stacked``, dispatched by
``kernels.ops.mesh_densify_stacked``) against the JAX package, against the
per-matrix loop it replaces, and the grouped kernel's descriptor packing.

Inputs are made with numpy from a seed and handed to both packages.  JAX's
``PhotonicMatrix.to_dense_stacked`` runs as its own tests run it on the
CPU: its plain path (``REPRO_KERNEL_MODE=ref``) and its Pallas mesh kernel
in interpret mode.  Tolerance against JAX: ``rtol = atol = 1e-6`` (the
same f32 rotations, sin/cos from two libraries).  Against the per-matrix
loop and the parent's ``prepare_params_stacked``: bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import photonic as jph
from repro.kernels import quant as jquant
from repro_torch import interop
from repro_torch.core import photonic as tph
from repro_torch.core import pinn, tt, zoo
from repro_torch.device import counter_generator
from repro_torch.kernels import mesh_apply as tmesh
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant as tquant
from test_torch_pinn import share_cores  # noqa: F401 (autouse)

RTOL = ATOL = 1e-6

# the (out, in) unfoldings of one TT layer's cores: the four of
# PAPER_TONN_SPEC (hidden 1024, ranks [1,2,1,2,1]) and the three of the
# REDUCED config's layer (hidden 64, tt_L 3)
GROUPS = {
    "paper": [(r * m, n * rn) for r, m, n, rn in
              tt.PAPER_TONN_SPEC.core_shapes],
    "reduced": [(r * m, n * rn) for r, m, n, rn in
                tt.hjb_layer_spec(64, 64, L=3, max_rank=2).core_shapes],
}


def _group_inputs(dims, S, noisy, seed):
    """numpy params (phases, sigma, diag buffers; (P,) diags on odd
    matrices, (S, P) on even ones) and chip noise per matrix."""
    rng = np.random.RandomState(seed)
    params, noises = [], []
    for g, (out_dim, in_dim) in enumerate(dims):
        lu = jph.rectangular_layout(out_dim).phase_shape()
        lv = jph.rectangular_layout(in_dim).phase_shape()
        diag_lead = () if g % 2 else (S,)
        p = {"phases_u": rng.uniform(-np.pi, np.pi, (S, *lu)),
             "phases_v": rng.uniform(-np.pi, np.pi, (S, *lv)),
             "sigma": rng.uniform(0.2, 1.5, (S, min(out_dim, in_dim))),
             "diag_u": rng.choice([-1.0, 1.0], (*diag_lead, out_dim)),
             "diag_v": rng.choice([-1.0, 1.0], (*diag_lead, in_dim))}
        params.append({k: v.astype(np.float32) for k, v in p.items()})
        noises.append({side: {
            "gamma": (1.0 + 0.002 * rng.standard_normal(shape)).astype(
                np.float32),
            "bias": rng.uniform(0.0, 2 * np.pi, shape).astype(np.float32)}
            for side, shape in (("u", lu), ("v", lv))} if noisy else None)
    return params, noises


def _port_args(dims, params, noises, noisy, bits):
    mats = [tph.PhotonicMatrix(o, i) for o, i in dims]
    ps = [interop.params_from_numpy(p, "cpu") for p in params]
    nzs = [interop.noise_from_numpy(n, "cpu") for n in noises]
    quant = (tquant.QuantConfig(enabled=True, dtype=None, phase_bits=bits)
             if bits else None)
    return mats, ps, nzs, tph.NoiseModel(enabled=noisy), quant


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("S", [1, 3, 11])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_mesh_densify_matches_jax(group, S, noisy, bits, monkeypatch):
    dims = GROUPS[group]
    params, noises = _group_inputs(dims, S, noisy,
                                   seed=S + 2 * noisy + (bits or 0))
    got = tph.mesh_densify_stacked(*_port_args(dims, params, noises, noisy,
                                               bits))
    jmodel = jph.NoiseModel(enabled=noisy)
    jq = (jquant.QuantConfig(enabled=True, dtype=None, phase_bits=bits)
          if bits else None)
    # the Pallas mesh kernel in interpret mode at one stack size (it costs
    # ~0.7 s a mesh on the CPU), the plain path at every one
    modes = ("ref", "interpret") if S == 3 else ("ref",)
    for mode in modes:
        monkeypatch.setenv("REPRO_KERNEL_MODE", mode)
        for (out_dim, in_dim), p, nz, w in zip(dims, params, noises, got):
            jm = jph.PhotonicMatrix(out_dim, in_dim)
            want = np.asarray(jm.to_dense_stacked(
                jax.tree.map(jnp.asarray, p), jmodel,
                nz and jax.tree.map(jnp.asarray, nz), quant=jq))
            assert tuple(w.shape) == (S, out_dim, in_dim)
            assert w.is_contiguous()
            np.testing.assert_allclose(w.numpy(), want, rtol=RTOL,
                                       atol=ATOL, err_msg=mode)


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_twin_equals_the_per_matrix_loop_bitwise(group, noisy, bits):
    """The grouped twin is the loop of ``to_dense_stacked`` it replaces,
    bit for bit, and the dispatcher takes it on the CPU without a
    launch."""
    dims = GROUPS[group]
    params, noises = _group_inputs(dims, 3, noisy, seed=7)
    mats, ps, nzs, model, quant = _port_args(dims, params, noises, noisy,
                                             bits)
    before = (tmesh.mesh_densify_stacked.launches,
              tmesh.mesh_apply_stacked.launches)
    got = tops.mesh_densify_stacked(mats, ps, nzs, model, quant)
    assert (tmesh.mesh_densify_stacked.launches,
            tmesh.mesh_apply_stacked.launches) == before
    for pm, p, nz, w in zip(mats, ps, nzs, got):
        loop = pm.to_dense_stacked(p, model if nz else None, nz, quant)
        assert torch.equal(w, loop)


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("hidden,tt_L", [(64, 3), (1024, 4)])
def test_prepare_params_stacked_bitwise_as_before(hidden, tt_L, bits):
    """``prepare_params_stacked`` through the one grouped call gives the
    cores of the per-core loop it replaced (``to_dense_stacked``, reshaped
    to the core, made contiguous), bit for bit, noise on."""
    quant = (tquant.QuantConfig(enabled=True, dtype=None, phase_bits=bits)
             if bits else tquant.QuantConfig())
    cfg = pinn.PINNConfig(hidden=hidden, mode="tonn", tt_L=tt_L,
                          deriv="fd_fast", quant=quant,
                          noise=tph.NoiseModel(enabled=True))
    model = pinn.TensorPinn(cfg)
    params = model.init(counter_generator(0))
    noise = model.sample_noise(counter_generator(0, 99))
    xis = zoo.sample_perturbations(counter_generator(2), params, 10,
                                   model.trainable_mask(params))
    stacked = zoo.perturbed_stack(params, xis, zoo.SPSAConfig(num_samples=10))
    prepared = model.prepare_params_stacked(stacked, noise)
    for i, spec in enumerate(model.specs):
        assert len(prepared[f"cores{i}"]) == spec.L
        for k, pm in enumerate(model.photonic_cores[i]):
            nz = noise[f"pcores{i}"][k]
            want = pm.to_dense_stacked(
                stacked[f"pcores{i}"][k], cfg.noise, nz,
                quant if bits else None).reshape(
                    11, *spec.core_shapes[k]).contiguous()
            got = prepared[f"cores{i}"][k]
            assert got.is_contiguous() and torch.equal(got, want)


def _packed(dims, S=3, noisy=True, bits=8, crosstalk=0.005):
    params, noises = _group_inputs(dims, S, noisy, seed=3)
    mats, ps, nzs, _, quant = _port_args(dims, params, noises, noisy, bits)
    model = tph.NoiseModel(enabled=noisy, crosstalk=crosstalk)
    out = [torch.empty((S, pm.out_dim, pm.in_dim)) for pm in mats]
    return mats, ps, nzs, model, quant, out


def test_descriptor_packing_shapes_and_flags():
    """The grouped kernel's ctypes descriptors: every pointer, dim, stride
    and flag of the paper layer's four matrices."""
    dims = GROUPS["paper"]
    mats, ps, nzs, model, quant, out = _packed(dims)
    grp = tmesh.pack_group(mats, ps, nzs, model, quant, out)
    assert (grp.count, grp.stack, grp.dac) == (4, 3, 1)
    assert grp.dac_step == np.float32(2 * math.pi / 256)
    assert grp.kappa == np.float32(0.005)
    for g, (pm, p, nz, w) in enumerate(zip(mats, ps, nzs, out)):
        d = grp.m[g]
        assert (d.k, d.sigma, d.out) == (pm.k, p["sigma"].data_ptr(),
                                         w.data_ptr())
        for side, layout, key in ((d.u, pm.layout_u, "u"),
                                  (d.v, pm.layout_v, "v")):
            plan = tph.mesh_plan_tensors(layout, torch.device("cpu"))
            assert (side.ports, side.levels, side.slots) == (
                layout.ports, layout.levels, layout.slots)
            assert side.phases == p[f"phases_{key}"].data_ptr()
            assert side.diag == p[f"diag_{key}"].data_ptr()
            assert side.diag_stride_s == (0 if g % 2 else layout.ports)
            assert side.gamma == nz[key]["gamma"].data_ptr()
            assert side.bias == nz[key]["bias"].data_ptr()
            assert side.crosstalk == int(layout.slots > 1)
            assert (side.slot, side.sign, side.perm) == (
                plan["slot_i32"].data_ptr(), plan["sign"].data_ptr(),
                plan["perm"].data_ptr())
            assert plan["slot_i32"].dtype == torch.int32
            assert torch.equal(plan["slot_i32"].long(), plan["slot"])
    # noise off (or no crosstalk) and no DAC: null noise, flags down
    for noisy, xt in ((False, 0.005), (True, 0.0)):
        mats, ps, nzs, model, _, out = _packed(dims, noisy=noisy,
                                               crosstalk=xt)
        grp = tmesh.pack_group(mats, ps, nzs, model, None, out)
        assert grp.dac == 0 and grp.kappa == 0.0
        for g in range(4):
            for side in (grp.m[g].u, grp.m[g].v):
                assert side.crosstalk == 0
                assert (side.gamma is None) == (not noisy)


def test_descriptor_packing_refuses_what_the_kernel_cannot_take():
    dims = GROUPS["paper"]
    mats, ps, nzs, model, quant, out = _packed(dims)
    with pytest.raises(ValueError, match="1..20"):
        tmesh.pack_group([], [], [], model, quant, [])
    with pytest.raises(ValueError, match="1..20"):
        tmesh.pack_group(mats * 6, ps * 6, nzs * 6, model, quant, out * 6)
    with pytest.raises(ValueError, match="1..20"):
        tmesh.pack_group(mats, ps[:3], nzs, model, quant, out)
    bad = dict(ps[1], sigma=ps[1]["sigma"][:2])            # another S
    with pytest.raises(ValueError, match="sigma"):
        tmesh.pack_group(mats, [ps[0], bad, *ps[2:]], nzs, model, quant, out)
    bad = dict(ps[0], phases_v=ps[0]["phases_v"].transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="matrix 0 v phases"):
        tmesh.pack_group(mats, [bad, *ps[1:]], nzs, model, quant, out)
    bad = dict(ps[2], phases_u=ps[2]["phases_u"].transpose(0, 1)
               .contiguous().transpose(0, 1))                # strided
    with pytest.raises(ValueError, match="contiguous"):
        tmesh.pack_group(mats, [*ps[:2], bad, ps[3]], nzs, model, quant, out)
    with pytest.raises(ValueError, match="out"):
        tmesh.pack_group(mats, ps, nzs, model, quant,
                         [out[0].double(), *out[1:]])
    with pytest.raises(ValueError, match="stack"):
        tmesh.pack_group(mats, [dict(p, sigma=p["sigma"][0]) for p in ps],
                         nzs, model, quant, out)
    # a matrix whose meshes do not fit a block's shared memory
    assert tmesh.densify_smem_bytes(tph.PhotonicMatrix(100, 100)) <= \
        tmesh.SMEM_MAX_BYTES
    wide = tph.PhotonicMatrix(110, 110)
    assert tmesh.densify_smem_bytes(wide) > tmesh.SMEM_MAX_BYTES
    p = {k: torch.zeros(1, *v.shape) for k, v in wide.init(
        torch.Generator().manual_seed(0)).items()}
    with pytest.raises(ValueError, match="shared memory"):
        tmesh.pack_group([wide], [p], [None], None, None,
                         [torch.empty(1, 110, 110)])
    # the kernel wrapper itself runs on CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        tmesh.mesh_densify_stacked(mats, ps, nzs, model, quant)
