"""The port's ``TensorPinn`` (tt and tonn modes; dense in ``test_torch_bp``)
and PDE surface against the JAX package's.

Params and hardware noise come from the JAX side as numpy trees and reach
the port through ``repro_torch.interop``; query points are made with numpy
from a seed.  Tolerance for u-values: ``rtol=1e-5, atol=1e-5`` — both sides
reassociate the f32 sums of 4 chain steps and take sin from two libraries.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pde as jpde
from repro.core import pinn as jpinn
from repro.core.photonic import NoiseModel as JNoise
from repro_torch import interop
from repro_torch import pde as tpde
from repro_torch.core import pinn as tpinn

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def share_cores():
    """torch's CPU threads cut to this process's share of the cores while
    a module's tests run (all of them outside pytest-xdist): six workers
    each at torch's default of a thread a core wait on each other more
    than they compute.  The heavy port modules import it too."""
    threads = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    yield
    torch.set_num_threads(threads)


PORTED_PDES = ("heat-10d", "heat-20d", "hjb-10d", "hjb-20d")

# label -> (pde, mode, noise, hidden, tt_L, n_points); REDUCED widths are
# configs/hjb_pinn.py's (hidden 64, L 3), the paper's hidden 1024 (L 4)
U_CASES = {
    "hjb20-tt-reduced": ("hjb-20d", "tt", False, 64, 3, 19),
    "hjb20-tonn-reduced": ("hjb-20d", "tonn", False, 64, 3, 19),
    "hjb20-tonn-noise-reduced": ("hjb-20d", "tonn", True, 64, 3, 19),
    "hjb10-tonn-noise-reduced": ("hjb-10d", "tonn", True, 64, 3, 7),
    "heat10-tt-reduced": ("heat-10d", "tt", False, 64, 3, 19),
    "heat10-tonn-noise-reduced": ("heat-10d", "tonn", True, 64, 3, 19),
    "hjb20-tonn-noise-paper": ("hjb-20d", "tonn", True, 1024, 4, 8),
    "heat10-tt-paper": ("heat-10d", "tt", False, 1024, 4, 8),
}


def _np_tree(tree):
    return None if tree is None else jax.tree.map(np.asarray, tree)


def _jax_solver(pde, mode, noise, hidden, tt_L, seed=0):
    cfg = jpinn.PINNConfig(hidden=hidden, mode=mode, tt_rank=2, tt_L=tt_L,
                           pde=pde, use_fused_kernel=True,
                           noise=JNoise(enabled=noise))
    model = jpinn.TensorPinn(cfg)
    key = jax.random.PRNGKey(seed)
    params = model.init(key)
    hw = model.sample_noise(jax.random.fold_in(key, 99))
    return cfg, model, params, hw


def _port_model(cfg):
    return tpinn.TensorPinn(tpinn.config_from_meta(
        json.loads(json.dumps(jpinn.config_to_meta(cfg)))))


def _points(n, width, seed):
    return np.random.RandomState(seed).uniform(
        0.02, 0.98, (n, width)).astype(np.float32)


# ------------------------------------------------------------------ problems

@pytest.mark.parametrize("name", PORTED_PDES)
def test_problem_surface_matches_jax(name):
    jp, tp = jpde.get_problem(name), tpde.get_problem(name)
    for attr in ("name", "space_dim", "time_dependent", "in_dim", "net_dim",
                 "n_coeffs", "has_feature_map"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    assert tp.coeff_spec is None and jp.coeff_spec is None
    xt = _points(11, tp.in_dim, seed=len(name))
    f = np.random.RandomState(1).standard_normal(11).astype(np.float32)
    np.testing.assert_allclose(
        tp.ansatz(torch.tensor(f), torch.tensor(xt)).numpy(),
        np.asarray(jp.ansatz(jnp.asarray(f), jnp.asarray(xt))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tp.exact_solution(torch.tensor(xt)).numpy(),
        np.asarray(jp.exact_solution(jnp.asarray(xt))),
        rtol=RTOL, atol=ATOL)
    pts = tp.sample_collocation(torch.Generator().manual_seed(0), 500)
    assert tuple(pts.shape) == (500, tp.in_dim) and pts.dtype == torch.float32
    assert float(pts.min()) >= tp.margin and float(pts.max()) <= 1 - tp.margin


def test_registry_names_and_errors():
    assert set(PORTED_PDES) <= set(tpde.available())
    assert set(tpde.available()) <= set(jpde.available())
    assert tpde.get_problem("hjb-20d") is not tpde.get_problem("hjb-20d")
    for name in ("heat-10d-kappa", "hjb-10d-lam", "black-scholes-8d-rs",
                 "black-scholes-100d-rs"):      # the conditioned families
        assert tpde.get_problem(name).coeff_spec is not None
    with pytest.raises(KeyError):
        tpde.get_problem("heat-30d")
    with pytest.raises(ValueError):
        tpde.register("hjb-20d")(lambda: None)
    box = tpde.uniform_box(torch.Generator().manual_seed(0), 4, 3, -1.0, 2.0)
    assert tuple(box.shape) == (4, 3)
    assert -1.0 <= float(box.min()) and float(box.max()) <= 2.0


# -------------------------------------------------------------------- config

def test_config_meta_roundtrips_between_packages():
    from repro.kernels.quant import QuantConfig as JQuant
    jcfg = jpinn.PINNConfig(hidden=48, mode="tonn", tt_rank=2, tt_L=4,
                            pde="hjb-10d", deriv="fd_fast", fd_step=2e-2,
                            use_fused_kernel=True, spectral_points=16,
                            noise=JNoise(enabled=True, gamma_std=0.004),
                            quant=JQuant(enabled=True, dtype="fp8_e4m3",
                                         phase_bits=8))
    meta = json.loads(json.dumps(jpinn.config_to_meta(jcfg)))
    tcfg = tpinn.config_from_meta(meta)
    assert tpinn.config_to_meta(tcfg) == meta
    assert jpinn.config_from_meta(tpinn.config_to_meta(tcfg)) == jcfg
    # newer writers' keys are ignored, older meta takes defaults
    meta["from_the_future"] = 1
    meta["noise"]["also_new"] = 2
    assert tpinn.config_from_meta(meta) == tcfg
    assert tpinn.config_from_meta({}) == tpinn.PINNConfig()
    assert tpinn.config_to_meta(tpinn.PINNConfig()) == \
        json.loads(json.dumps(jpinn.config_to_meta(jpinn.PINNConfig())))


@pytest.mark.parametrize("pde,hidden,tt_L", [("hjb-20d", 1024, 4),
                                             ("heat-10d", 64, 3),
                                             ("hjb-10d", 16, 3),
                                             ("heat-20d", 8, 2)])
def test_model_geometry_matches_jax(pde, hidden, tt_L):
    for mode in ("tt", "tonn"):
        cfg = jpinn.PINNConfig(hidden=hidden, mode=mode, tt_L=tt_L, pde=pde)
        jm, tm = jpinn.TensorPinn(cfg), _port_model(cfg)
        assert (tm.in_dim, tm.net_in, tm.in_pad, tm.dims) == \
            (jm.in_dim, jm.net_in, jm.in_pad, jm.dims)
        assert [(s.out_modes, s.in_modes, s.ranks) for s in tm.specs] == \
            [(s.out_modes, s.in_modes, s.ranks) for s in jm.specs]
        if mode == "tonn":
            assert [[(p.out_dim, p.in_dim) for p in ps]
                    for ps in tm.photonic_cores] == \
                [[(p.out_dim, p.in_dim) for p in ps]
                 for ps in jm.photonic_cores]


@pytest.mark.parametrize("mode", ["tt", "tonn"])
def test_init_and_noise_trees_match_jax(mode):
    cfg, jm, params, hw = _jax_solver("hjb-10d", mode, True, 16, 3)
    tm = _port_model(cfg)
    gen = torch.Generator().manual_seed(0)
    shapes = jax.tree.map(np.shape, params)
    assert jax.tree.map(lambda t: tuple(t.shape), tm.init(gen)) == shapes
    noise = tm.sample_noise(gen)
    if mode == "tt":
        assert hw is None and noise is None
    else:
        assert jax.tree.map(lambda t: tuple(t.shape), noise) == \
            jax.tree.map(np.shape, hw)


def test_unported_modes_raise():
    """Every mode of the JAX package is ported (``onn`` since item 6b); a
    mode neither package has raises and names the four."""
    assert tpinn.PORTED_MODES == ("dense", "onn", "tt", "tonn")
    with pytest.raises(ValueError, match="unknown mode 'xnn'.*onn"):
        tpinn.TensorPinn(tpinn.PINNConfig(hidden=16, mode="xnn"))


# ------------------------------------------------------------------- forward

@pytest.mark.parametrize("label", sorted(U_CASES))
def test_u_matches_jax(label):
    pde, mode, noise, hidden, tt_L, n = U_CASES[label]
    cfg, jm, params, hw = _jax_solver(pde, mode, noise, hidden, tt_L,
                                      seed=len(label))
    pts = _points(n, jm.net_in, seed=n)
    u_jax = np.asarray(jm.u(params, jnp.asarray(pts), hw))
    tm = _port_model(cfg)
    tparams = interop.params_from_numpy(_np_tree(params), "cpu")
    tnoise = interop.noise_from_numpy(_np_tree(hw), "cpu")
    with torch.no_grad():
        u = tm.u(tparams, torch.tensor(pts), tnoise)
        # prepared params (the registry's form) give the same values
        prepared, left = tm.prepare_params(tparams, tnoise)
        u_prepared = tm.u(prepared, torch.tensor(pts))
    assert left is None and tuple(u.shape) == (n,)
    np.testing.assert_allclose(u.numpy(), u_jax, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(u_prepared.numpy(), u.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_prepared_cores_match_jax_densification():
    """Load-time densification: every TONN core mesh, noise baked in, gives
    the JAX package's TT-core."""
    cfg, jm, params, hw = _jax_solver("hjb-20d", "tonn", True, 1024, 4,
                                      seed=2)
    jprep, _ = jm.prepare_params(params, hw)
    tm = _port_model(cfg)
    tprep, _ = tm.prepare_params(
        interop.params_from_numpy(_np_tree(params), "cpu"),
        interop.noise_from_numpy(_np_tree(hw), "cpu"))
    assert set(tprep) == set(jprep)
    for i in range(2):
        for got, want in zip(tprep[f"cores{i}"], jprep[f"cores{i}"]):
            assert tuple(got.shape) == tuple(want.shape)
            assert got.is_contiguous()
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)
    # tt params pass through untouched
    ttm = tpinn.TensorPinn(tpinn.PINNConfig(hidden=16, mode="tt", tt_L=3))
    p = ttm.init(torch.Generator().manual_seed(0))
    assert ttm.prepare_params(p, None) == (p, None)

