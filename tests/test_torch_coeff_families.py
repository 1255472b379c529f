"""The port's coefficient-conditioned PDE families against the JAX package:
the counterpart of ``tests/test_coeff_families.py``.

``CoeffSpec`` (validation, meta, ranges, defaults, ``normalize``), the four
conditioned registrations and their closed forms, the model over augmented
rows (``_embed``, u, ``u_coeff_grid[_stacked]``, the stencils of every
estimator), the grouped collocation draws, the trainer's ``--coeff-*``
flags and conditioned serving.

Both packages get the same arrays (params, ξ, rows with their coefficients,
coefficient draws) made with numpy from a seed or by JAX and handed over.
JAX's ``CoeffSpec.sample`` draws from threefry and the port's from a
``torch.Generator``, so no test compares the two samplers' draws: they are
held to the same statistics and the same ranges instead.  Tolerances:

* ``normalize``, ``_embed`` and u over augmented rows: f32 strict, ``1e-6``
  relative (the same elementwise ops, the log in the same order);
* the stencils' u: ``1e-6·max|u|``; their losses at the FD floor (``rtol
  1e-1``), Stein's on the same directions at ``rtol 1e-4`` and the
  spectral ones at ``2·A·k_max²·1e-6`` (``test_torch_spectral``);
* served u against ``model.u`` on the same augmented rows: 1 f32 ulp (a
  pool of another size may round the last bit of the head's sum
  differently on the CPU);
* a few BP AdamW steps: the losses at ``RTOL_BP``, the updated params
  within ``STEP_SHARE`` of a step's size (lr) per element (AdamW divides
  each gradient by its running RMS, so an f32-floor difference in a
  small gradient moves its update by a share of lr: measured 7e-4).

The reference's 400–800-step family training runs on the card only
(``chip_smoke.py``'s ``train-coeff``, ``benchmarks/torch_coeff_family.py``).
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import pde as jpde
from repro.core import pinn as jpinn
from repro.core.photonic import NoiseModel as JNoise
from repro.optim import optimizers as jopt
from repro_torch import interop
from repro_torch import pde as tpde
from repro_torch.checkpoint import read_checkpoint_meta
from repro_torch.core import pinn as tpinn
from repro_torch.core import spectral as tspec
from repro_torch.core import stein as tstein
from repro_torch.core import zoo
from repro_torch.data import pde_collocation_iterator, tile_coeff_draws
from repro_torch.launch import train
from repro_torch.optim import get_optimizer
from repro_torch.serving import PdeServingEngine, PointRequest, SolverRegistry
from test_torch_pinn import _np_tree, share_cores  # noqa: F401 (autouse)

FAMILIES = ("heat-10d-kappa", "hjb-10d-lam", "black-scholes-8d-rs",
            "black-scholes-100d-rs")
CPU = "cpu"
U_RTOL = 1e-6
RTOL_BP = 1e-4
STEP_SHARE = 1e-2


def _draws(spec, n, seed):
    """(n, K) coefficient vectors inside ``spec``'s ranges, from numpy."""
    rs = np.random.RandomState(seed)
    lo, hi = np.asarray(spec.lo), np.asarray(spec.hi)
    return (lo + rs.uniform(0.05, 0.95, (n, spec.n)) * (hi - lo)).astype(
        np.float32)


def _rows(name, n, seed=0, problem=None):
    """JAX's augmented collocation rows of ``name`` as numpy."""
    jp = problem if problem is not None else jpde.get_problem(name)
    return np.asarray(jp.sample_collocation(jax.random.PRNGKey(seed), n))


def _pair(name, mode="tt", hidden=16, tt_L=2, noise=False, dist=None,
          **cfg_kw):
    """JAX's model, params and chip noise (numpy) and the port's model, on
    problem instances with the same ranges (``dist`` rebinds both)."""
    cfg = jpinn.PINNConfig(hidden=hidden, mode=mode, tt_rank=2, tt_L=tt_L,
                           pde=name, noise=JNoise(enabled=noise), **cfg_kw)
    jp, tp = jpde.get_problem(name), tpde.get_problem(name)
    if dist is not None:
        jp.coeff_spec = jp.coeff_spec.with_ranges({}, dist=dist)
        tp.coeff_spec = tp.coeff_spec.with_ranges({}, dist=dist)
    jm = jpinn.TensorPinn(cfg, problem=jp)
    key = jax.random.PRNGKey(len(name))
    params = _np_tree(jax.jit(jm.init)(key))
    hw = _np_tree(jm.sample_noise(jax.random.fold_in(key, 99)))
    tm = tpinn.TensorPinn(tpinn.config_from_meta(
        json.loads(json.dumps(jpinn.config_to_meta(cfg)))), problem=tp)
    return cfg, jm, params, hw, tm


def _stack(params, mask, P=3, seed=5):
    """P parameter sets around ``params`` (entry 0 itself), ξ from numpy;
    the ±1 diag buffers stay."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p, m: np.stack([p] + [
            (p + 0.01 * m * rs.standard_normal(p.shape)).astype(np.float32)
            for _ in range(P - 1)]), params, mask)


def _relmax(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _within_ulp(got, want):
    want32 = np.asarray(want, np.float32)
    return bool((np.abs(np.asarray(got, np.float64) - want32)
                 <= np.spacing(np.abs(want32))).all())


# ---------------------------------------------------------------- CoeffSpec

@pytest.mark.parametrize("args,kw", [
    ((("a", "b"), (0.0,), (1.0, 2.0)), {}),
    (((), (), ()), {}),
    ((("a",), (0.0,), (1.0,)), {"dist": "normal"}),
    ((("a",), (1.0,), (1.0,)), {}),
    ((("a",), (0.0,), (1.0,)), {"dist": "loguniform"})])
def test_coeff_spec_validation_errors_match_jax(args, kw):
    with pytest.raises(ValueError) as want:
        jpde.CoeffSpec(*args, **kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tpde.CoeffSpec(*args, **kw)


def test_coeff_spec_meta_ranges_defaults_and_range_checks():
    spec = tpde.CoeffSpec(("r", "sigma"), (0.01, 0.2), (0.1, 0.6),
                          dist="loguniform")
    jspec = jpde.CoeffSpec(("r", "sigma"), (0.01, 0.2), (0.1, 0.6),
                           dist="loguniform")
    back = tpde.CoeffSpec.from_meta(json.loads(json.dumps(spec.to_meta())))
    assert back == spec and spec.to_meta() == jspec.to_meta()
    assert jpde.CoeffSpec.from_meta(spec.to_meta()) == jspec
    assert tpde.CoeffSpec.from_meta({"names": ["k"], "lo": [1],
                                     "hi": [2]}).dist == "uniform"
    np.testing.assert_array_equal(spec.defaults(), jspec.defaults())
    np.testing.assert_allclose(
        dataclasses.replace(spec, dist="uniform").defaults(), [0.055, 0.4])
    wide = spec.with_ranges({"sigma": (0.1, 0.9)}, dist="uniform")
    assert wide == tpde.CoeffSpec(("r", "sigma"), (0.01, 0.1), (0.1, 0.9))
    assert wide.to_meta() == jspec.with_ranges({"sigma": (0.1, 0.9)},
                                               dist="uniform").to_meta()
    assert spec.with_ranges({}) == spec
    with pytest.raises(ValueError, match=r"unknown coefficient\(s\) \['mu'\]"):
        spec.with_ranges({"mu": (0, 1)})
    spec.check_in_range(spec.defaults())
    spec.check_in_range([0.1 + 1e-9, 0.2])          # inside the rtol slack
    for bad in ([0.05], [0.05, 0.3, 0.1], [0.2, 0.3], [0.05, 0.1]):
        with pytest.raises(ValueError) as want:
            jspec.check_in_range(bad)
        with pytest.raises(ValueError) as got:
            spec.check_in_range(bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dist", ["uniform", "loguniform"])
def test_normalize_matches_jax(dist):
    jspec = jpde.CoeffSpec(("r", "sigma"), (0.01, 0.2), (0.1, 0.6), dist)
    spec = tpde.CoeffSpec(("r", "sigma"), (0.01, 0.2), (0.1, 0.6), dist)
    c = _draws(spec, 257, seed=1)
    want = np.asarray(jspec.normalize(jnp.asarray(c)))
    got = spec.normalize(torch.tensor(c)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=U_RTOL, atol=U_RTOL)
    # the range's ends map to 0 and 1
    ends = spec.normalize(torch.tensor([spec.lo, spec.hi]))
    np.testing.assert_allclose(ends.numpy(), [[0, 0], [1, 1]], atol=1e-6)


@pytest.mark.parametrize("dist", ["uniform", "loguniform"])
def test_sample_statistics_match_jax(dist):
    """Different generators, the same law: normalized draws of both
    samplers are uniform on [0, 1] (mean, quartiles within 0.02 of each
    other and of the law's), inside the ranges, and the port's draws are
    the same for the same generator seed."""
    n = 20000
    jspec = jpde.CoeffSpec(("a", "b"), (0.05, 0.3), (0.5, 3.0), dist)
    spec = tpde.CoeffSpec(("a", "b"), (0.05, 0.3), (0.5, 3.0), dist)
    jz = np.asarray(jspec.normalize(jspec.sample(jax.random.PRNGKey(0), n)))
    c = spec.sample(torch.Generator().manual_seed(0), n)
    assert c.shape == (n, 2) and c.dtype == torch.float32
    assert torch.equal(c, spec.sample(torch.Generator().manual_seed(0), n))
    assert (c.numpy() >= np.float32(spec.lo)).all()
    assert (c.numpy() <= np.float32(spec.hi)).all()
    z = spec.normalize(c).numpy()
    for q in (0.25, 0.5, 0.75):
        assert abs(np.quantile(z, q) - q) < 0.02
        assert abs(np.quantile(z, q) - np.quantile(jz, q)) < 0.02
    assert abs(z.mean() - jz.mean()) < 0.02


@settings(deadline=None, max_examples=10)
@given(lo=st.floats(0.05, 2.0), width=st.floats(0.1, 4.0),
       n=st.integers(1, 64), dist=st.sampled_from(["uniform", "loguniform"]),
       seed=st.integers(0, 2**31 - 1))
def test_coeff_sampler_in_range_and_deterministic(lo, width, n, dist, seed):
    """The port's counterpart of the reference's property
    (``tests/test_properties.py``): ``sample`` stays inside [lo, hi] for
    any range and distribution, is deterministic for a generator seed,
    normalizes into [0, 1] and round-trips through meta."""
    hi = lo + width
    spec = tpde.CoeffSpec(("a", "b"), (lo, lo * 2), (hi, hi * 2), dist=dist)
    c = spec.sample(torch.Generator().manual_seed(seed), n).numpy()
    assert c.shape == (n, 2)
    assert (c >= np.asarray(spec.lo) - 1e-6).all()
    assert (c <= np.asarray(spec.hi) + 1e-6).all()
    np.testing.assert_array_equal(
        c, spec.sample(torch.Generator().manual_seed(seed), n).numpy())
    z = spec.normalize(torch.tensor(c)).numpy()
    assert (z >= -1e-5).all() and (z <= 1.0 + 1e-5).all()
    assert tpde.CoeffSpec.from_meta(spec.to_meta()) == spec
    spec.check_in_range(spec.defaults())


# ----------------------------------------------------------------- problems

@pytest.mark.parametrize("name", FAMILIES)
def test_exact_solution_satisfies_residual_per_coefficient(name):
    """At 5 coefficient vectors: the closed form equals JAX's on the same
    augmented rows and satisfies its own coefficient's residual under the
    FD estimator below ``residual_tol``."""
    jp, tp = jpde.get_problem(name), tpde.get_problem(name)
    pts = _rows(name, 200, seed=11)[:, :tp.in_dim]
    for c in _draws(tp.coeff_spec, 5, seed=3):
        xt = tp.attach_coeffs(torch.tensor(pts), c)
        np.testing.assert_array_equal(
            xt.numpy(), np.asarray(jp.attach_coeffs(jnp.asarray(pts),
                                                    jnp.asarray(c))))
        np.testing.assert_allclose(
            tp.exact_solution(xt).numpy(),
            np.asarray(jp.exact_solution(jnp.asarray(xt.numpy()))),
            rtol=U_RTOL)
        est = tstein.fd_estimate(tp.exact_solution, xt, h=tp.fd_step,
                                 n_active=tp.in_dim)
        assert tuple(est.grad.shape) == (200, tp.in_dim)
        r2 = float(torch.mean(tp.residual(est, xt) ** 2))
        assert r2 < tp.residual_tol, (name, c, r2)


def test_samplers_pins_and_boundary_faces():
    """Unconditioned samplers draw as before, bit for bit; conditioned ones
    append a draw a row; the pins and heat's Dirichlet faces."""
    g = lambda: torch.Generator().manual_seed(4)
    heat = tpde.get_problem("heat-10d")
    assert torch.equal(heat.sample_collocation(g(), 9),
                       tpde.uniform_box(g(), 9, 11, 0.02, 0.98))
    assert heat.attach_coeffs(torch.zeros(3, 11), [1.0]).shape == (3, 11)
    fam = tpde.get_problem("heat-10d-kappa")
    xt = fam.sample_collocation(g(), 9)
    assert torch.equal(xt[:, :11], heat.sample_collocation(g(), 9))
    pts, c = fam.split_coeffs(xt)
    assert pts.shape == (9, 11) and c.shape == (9, 1)
    # pins: a dedicated κ, λ, (r, σ), each its own closed form
    rows = torch.tensor(_rows("heat-10d", 7, seed=2))
    for tp, jp in ((tpde.HeatProblem(space_dim=10, kappa=1.7),
                    jpde.HeatProblem(space_dim=10, kappa=1.7)),
                   (tpde.HJBProblem(space_dim=10, lam=0.12),
                    jpde.HJBProblem(space_dim=10, lam=0.12))):
        assert tp.name == jp.name and tp.coeff_spec is None
        assert tp.has_boundary_loss == jp.has_boundary_loss
        np.testing.assert_allclose(
            tp.exact_solution(rows).numpy(),
            np.asarray(jp.exact_solution(jnp.asarray(rows.numpy()))),
            rtol=U_RTOL)
    with pytest.raises(ValueError, match="both r and sigma"):
        tpde.BlackScholesProblem(space_dim=8, r_range=(0.01, 0.1))
    # heat's faces: one coordinate on a face, the closed form as target
    xb, ub = fam.boundary_batch(g(), 64)
    assert xb.shape == (64, 12)
    on_face = ((xb[:, :10] == 0) | (xb[:, :10] == 1)).sum(-1)
    assert (on_face >= 1).all()
    assert torch.equal(ub, fam.exact_solution(xb))
    assert tpde.get_problem("heat-10d").boundary_batch(g(), 4) is None
    assert [t.name for t in fam.loss_terms()] == ["residual", "boundary"]


# -------------------------------------------------------------------- model

@pytest.mark.parametrize("name,dist", [
    ("heat-10d-kappa", None), ("heat-10d-kappa", "loguniform"),
    ("black-scholes-100d-rs", None)])
def test_embed_and_u_over_augmented_rows_match_jax(name, dist):
    """``_embed`` normalizes the coefficient slots before the pad, as
    JAX's does, and u over the same augmented rows agrees; the physical
    columns pass as they are."""
    cfg, jm, params, hw, tm = _pair(name, dist=dist)
    xt = _rows(name, 33, seed=1, problem=jm.problem)
    want = np.asarray(jm._embed(jnp.asarray(xt)))
    got = tm._embed(torch.tensor(xt)).numpy()
    assert got.shape == (33, tm.in_pad) == want.shape
    np.testing.assert_allclose(got, want, rtol=U_RTOL, atol=U_RTOL)
    np.testing.assert_array_equal(got[:, :tm.in_dim], xt[:, :tm.in_dim])
    assert (got[:, tm.net_in:] == 0).all()
    want_u = np.asarray(jax.jit(lambda p, x: jm.u(p, x))(params,
                                                          jnp.asarray(xt)))
    got_u = tm.u(interop.params_from_numpy(params, CPU),
                 torch.tensor(xt)).numpy()
    assert _relmax(got_u, want_u) <= U_RTOL


@pytest.mark.parametrize("mode,noise", [("tt", False), ("tonn", True)])
def test_u_coeff_grid_and_stacked_match_jax(mode, noise):
    """(C, B) and (P, C, B) u over the coefficient × point grid through one
    flattened forward each; row c of the grid is u on the points with
    coefficient c attached."""
    name = "black-scholes-8d-rs"
    cfg, jm, params, hw, tm = _pair(name, mode=mode, noise=noise)
    pts = _rows(name, 13, seed=2)[:, :tm.in_dim]
    coeffs = _draws(tm.problem.coeff_spec, 4, seed=6)
    stacked = _stack(params, jm.trainable_mask(params))

    @jax.jit
    def reference(p, s, h):
        return (jm.u_coeff_grid(p, jnp.asarray(pts), jnp.asarray(coeffs), h),
                jm.u_coeff_grid_stacked(jm.prepare_params_stacked(s, h),
                                        jnp.asarray(pts),
                                        jnp.asarray(coeffs)))

    want, want_st = map(np.asarray, reference(params, stacked, hw))
    tp = interop.params_from_numpy(params, CPU)
    nz = interop.noise_from_numpy(hw, CPU)
    grid = tm.u_coeff_grid(tp, torch.tensor(pts), coeffs, nz)
    prep = tm.prepare_params_stacked(interop.params_from_numpy(stacked, CPU),
                                     nz)
    grid_st = tm.u_coeff_grid_stacked(prep, torch.tensor(pts),
                                      torch.tensor(coeffs))
    assert tuple(grid.shape) == (4, 13) and tuple(grid_st.shape) == (3, 4, 13)
    assert _relmax(grid.numpy(), want) <= U_RTOL
    assert _relmax(grid_st.numpy(), want_st) <= U_RTOL
    row = tm.u(tp, tm.problem.attach_coeffs(torch.tensor(pts), coeffs[2]),
               nz)
    torch.testing.assert_close(grid[2], row, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="not coefficient-conditioned"):
        tpinn.TensorPinn(dataclasses.replace(tm.cfg, pde="hjb-10d")
                         )._coeff_rows(torch.tensor(pts), coeffs)


def test_fd_fast_rank1_columns_are_unchanged_by_conditioning():
    """The identity columns of ``fd_fast`` span the physical inputs only,
    (in_dim, in_pad), and the rank-1 stencil equals u at the shifted
    augmented rows: the slot normalization is affine per slot and no
    stencil shifts a coefficient."""
    name = "hjb-10d-lam"
    cfg, jm, params, hw, tm = _pair(name, mode="tonn", noise=True)
    xt = torch.tensor(_rows(name, 17, seed=4))
    cols = tm._identity_columns(xt)
    assert tuple(cols.shape) == (tm.in_dim, tm.in_pad) == (11, 16)
    assert torch.equal(cols, torch.eye(11, 16))
    tp = interop.params_from_numpy(params, CPU)
    nz = interop.noise_from_numpy(hw, CPU)
    h = tm.fd_step
    fast = tm.fd_u_stencil(tp, xt, h, nz)
    pts = tpde.fd_stencil_points(xt, h, tm.in_dim)
    assert torch.equal(pts[..., tm.in_dim:],
                       xt[None, :, tm.in_dim:].expand(23, 17, 1))
    plain = tm.u(tp, pts.reshape(-1, tm.net_in), nz).reshape(23, 17)
    assert float((fast - plain).abs().max()) <= 1e-6 * float(
        plain.abs().max())


@pytest.mark.parametrize("deriv", ["fd", "stein", "spectral"])
def test_stacked_stencils_of_conditioned_rows_match_jax(deriv):
    """The stacked stencil's u of conditioned rows through each estimator
    (``fd_fast`` and its boundary term: ``test_torch_pde``'s FD cases)
    against JAX's, then the losses: fd at the FD floor, Stein on the
    same directions, spectral at its FFT floor."""
    name, M, B, P, S = "heat-10d-kappa", 8, 6, 3, 4
    cfg, jm, params, hw, tm = _pair(name, mode="tonn", noise=True,
                                    deriv=deriv, stein_samples=S,
                                    spectral_points=M)
    stacked = _stack(params, jm.trainable_mask(params), P)
    xt = _rows(name, B, seed=8)
    A = tm.in_dim
    key = jax.random.PRNGKey(9)
    z = np.stack([np.asarray(jax.random.normal(k, (S, *xt.shape)))
                  for k in jax.random.split(key, P)])
    z[..., A:] = 0.0                      # coefficient slots never move

    @jax.jit
    def reference(s, h):
        prep = jm.prepare_params_stacked(s, h)
        x = jnp.asarray(xt)
        if deriv == "fd":
            rows = jpde.fd_stencil_points(x, jm.fd_step, A).reshape(-1, 12)
        elif deriv == "stein":
            zz = jnp.asarray(z)
            rows = jnp.concatenate(
                [jnp.broadcast_to(x, (P, 1, B, 12)),
                 x + cfg.stein_sigma * zz,
                 x - cfg.stein_sigma * zz], axis=1).reshape(P, -1, 12)
        else:
            from repro.core import spectral as jspec
            rows = jspec.spectral_line_rows(x, A, M, 1.0)
        losses = jpinn.residual_losses_stacked(jm, s, x, h, key=key)
        return jm.u_stacked(prep, rows), losses

    want_u, want_l = map(np.asarray, reference(stacked, hw))
    tstacked = interop.params_from_numpy(stacked, CPU)
    nz = interop.noise_from_numpy(hw, CPU)
    x = torch.tensor(xt)
    with torch.no_grad():
        prep = tm.prepare_params_stacked(tstacked, nz)
        if deriv == "fd":
            rows = tpde.fd_stencil_points(x, tm.fd_step, A).reshape(-1, 12)
            got_u = tm.u_stacked(prep, rows)
        elif deriv == "stein":
            got_u = tm.stein_u_stacked(prep, x, torch.tensor(z),
                                       cfg.stein_sigma).reshape(P, -1)
        else:
            got_u = tm.u_stacked(prep, tspec.spectral_line_rows(x, A, M, 1.0))
        got_l = tpinn.residual_losses_stacked(tm, tstacked, x, nz,
                                              z=torch.tensor(z))
    assert got_u.shape == want_u.shape
    assert _relmax(got_u.numpy(), want_u) <= U_RTOL
    rtol = {"fd": 1e-1, "stein": 1e-4,
            "spectral": 2.0 * A * (np.pi * M) ** 2 * U_RTOL}[deriv]
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=rtol)


def test_bp_adamw_steps_match_jax():
    """Three BP AdamW steps of hjb-10d-lam (tt, hidden 16) on the same
    params and batches in both packages: the losses and the params after
    each step agree (``RTOL_BP``, ``STEP_SHARE``).  FD at h = 5e-2 keeps the losses' f32
    floor under the tolerance."""
    name, steps, lr = "hjb-10d-lam", 3, 3e-3
    cfg, jm, params, hw, tm = _pair(name, fd_step=5e-2)
    batches = [_rows(name, 32, seed=20 + i) for i in range(steps)]
    mask = jm.trainable_mask(params)
    jo = jopt.adamw(lr=lr)

    @jax.jit
    def jstep(p, aux, xt):
        loss, g = jax.value_and_grad(
            lambda q: jpinn.residual_loss(jm, q, xt))(p)
        g = jax.tree.map(lambda a, t: a if t else jnp.zeros_like(a), g, mask)
        new, aux = jo.update(g, aux, p)
        return new, aux, loss

    jp = jax.tree.map(jnp.asarray, params)
    jaux = jo.init(jp)
    tparams = interop.params_from_numpy(params, CPU)
    opt = get_optimizer("adamw", lr=lr)
    step = train._bp_step_fn(tm, opt, tm.trainable_mask(tparams), None)
    state = opt.init(tparams)
    for xt in batches:
        jp, jaux, jl = jstep(jp, jaux, jnp.asarray(xt))
        tparams, state, tl = step(tparams, state, torch.tensor(xt), {})
        assert float(tl) == pytest.approx(float(jl), rel=RTOL_BP)
        for got, want in zip(zoo.tree_leaves(tparams),
                             jax.tree.leaves(_np_tree(jp))):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=STEP_SHARE * lr)


# --------------------------------------------------------------- data stream

@pytest.mark.parametrize("n,C", [(10, 3), (8, 8), (7, 1), (100, 4)])
def test_grouped_draws_tile_as_jax_does(n, C):
    """``tile_coeff_draws`` against the reference's tiling on the same
    (C, K) draws; the stream's grouped batches: the points of the
    ungrouped stream, C distinct vectors in groups of ceil(n / C),
    counter-based and restart-safe."""
    draws = _draws(tpde.get_problem("black-scholes-8d-rs").coeff_spec, C,
                   seed=C)
    want = np.asarray(jnp.repeat(jnp.asarray(draws), -(-n // C), axis=0)[:n])
    np.testing.assert_array_equal(
        tile_coeff_draws(torch.tensor(draws), n).numpy(), want)
    prob = tpde.get_problem("black-scholes-8d-rs")
    it = pde_collocation_iterator(n, seed=2, problem=prob, coeffs_per_step=C)
    batches = [next(it) for _ in range(3)]
    plain = pde_collocation_iterator(n, seed=2, problem=prob)
    later = pde_collocation_iterator(n, seed=2, start_step=2, problem=prob,
                                     coeffs_per_step=C)
    assert torch.equal(next(later), batches[2])
    for xt, iid in zip(batches, [next(plain) for _ in range(3)]):
        assert tuple(xt.shape) == (n, prob.net_dim)
        assert torch.equal(xt[:, :prob.in_dim], iid[:, :prob.in_dim])
        c = xt[:, prob.in_dim:].numpy()
        assert len(np.unique(c[:, 0])) == C
        for g in range(C):
            grp = c[g * -(-n // C):(g + 1) * -(-n // C)]
            assert (grp == grp[0]).all()
        prob.coeff_spec.check_in_range(c.min(0))
        prob.coeff_spec.check_in_range(c.max(0))
    assert not torch.equal(batches[0][:, -2:], batches[1][:, -2:])


@pytest.mark.parametrize("pde,C", [("hjb-10d", 2), ("hjb-10d-lam", 0),
                                   ("hjb-10d-lam", 9)])
def test_grouped_draw_errors_match_jax(pde, C):
    from repro.data import pde_collocation_iterator as jax_iterator
    with pytest.raises(ValueError) as want:
        next(jax_iterator(8, pde=pde, coeffs_per_step=C))
    with pytest.raises(ValueError) as got:
        next(pde_collocation_iterator(8, pde=pde, coeffs_per_step=C))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------- CLI

CLI = ["--arch", "tensor-pinn", "--reduced", "--device", "cpu",
       "--log-every", "1", "--batch", "8", "--zo-samples", "3"]


@pytest.mark.parametrize("flags,spec", [
    (["--pde", "black-scholes-8d-rs", "--pinn-noise", "--coeffs-per-step",
      "4"], {"names": ["r", "sigma"], "lo": [0.01, 0.2], "hi": [0.1, 0.6],
             "dist": "uniform"}),
    (["--pde", "heat-10d-kappa", "--pinn-noise", "--coeff-range",
      "kappa=0.7:1.5", "--coeff-dist", "loguniform"],
     {"names": ["kappa"], "lo": [0.7], "hi": [1.5], "dist": "loguniform"}),
    (["--pde", "hjb-10d-lam", "--pinn-mode", "tt", "--optimizer", "adamw"],
     {"names": ["lam"], "lo": [0.05], "hi": [0.15], "dist": "uniform"})])
def test_cli_trains_the_conditioned_families(tmp_path, capsys, flags, spec):
    res = train.main(CLI + flags + ["--steps", "3", "--ckpt-dir",
                                    str(tmp_path)])
    out = capsys.readouterr().out
    assert "[pinn] conditioned on " in out and "net_in=" in out
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert np.isfinite(res.val_mse)
    assert res.model.problem.coeff_spec.to_meta() == spec
    meta = read_checkpoint_meta(tmp_path)
    assert meta["coeff_spec"] == spec and meta["pde"] == flags[1]
    if flags[1] == "heat-10d-kappa":      # its Dirichlet term is logged
        assert "boundary=" in out


@pytest.mark.parametrize("flags,message", [
    (["--pde", "heat-10d-kappa", "--coeff-range", "kappa=0.7"], "malformed"),
    (["--pde", "heat-10d-kappa", "--coeff-range", "mu=0.1:1"],
     "unknown coefficient"),
    (["--pde", "heat-10d-kappa", "--coeff-range", ","], "no ranges"),
    (["--pde", "black-scholes-8d-rs", "--coeff-range", "r=0:0.1",
      "--coeff-dist", "loguniform"], "loguniform needs lo > 0")])
def test_cli_coeff_range_errors_exit(flags, message):
    with pytest.raises(SystemExit, match=message):
        train.main(CLI + flags + ["--steps", "1"])


# ------------------------------------------------------------------ serving

@pytest.fixture(scope="module")
def family():
    """A conditioned tt solver (black-scholes-8d-rs, hidden 16) registered
    on the CPU, and its raw model and params."""
    cfg, jm, params, hw, tm = _pair("black-scholes-8d-rs")
    reg = SolverRegistry(device=CPU)
    reg.register("fam", tm, interop.params_from_numpy(params, CPU))
    reg.register_fresh("plain", dataclasses.replace(
        tm.cfg, pde="hjb-10d"), device=CPU)
    return reg, tm, interop.params_from_numpy(params, CPU)


def test_serving_rejects_bad_coefficients(family):
    reg, tm, _ = family
    eng = PdeServingEngine(reg, slots=2, slot_points=8, device=CPU)
    pts = _rows("black-scholes-8d-rs", 5)[:, :9]
    for coeffs, message in (([0.5, 0.3], "r=0.5 outside trained range"),
                            ([0.05, 0.1], "sigma=0.1 outside trained range"),
                            ([0.05], r"expected 2 coefficient\(s\)"),
                            ([0.05, 0.3, 1.0], "got 3"),
                            (None, "coefficient-conditioned on \\(r, sigma")):
        with pytest.raises(ValueError, match=message):
            eng.submit(PointRequest("fam", pts, coeffs=coeffs))
    with pytest.raises(ValueError, match="not coefficient-conditioned"):
        eng.submit(PointRequest("plain", np.full((3, 11), 0.5, np.float32),
                                coeffs=[0.1]))
    assert not eng.queue and eng.stats["compiles"] == 0
    assert reg.get("fam").n_coeffs == 2 and reg.get("plain").n_coeffs == 0
    assert reg.get("plain").coeff_spec is None


def test_one_program_serves_every_coefficient_instance(family):
    """One ``c2`` program, built at warm-up, serves four instances with no
    rebuild; each request's u is ``model.u`` on its augmented rows within
    an ulp; the cache keys the augmented rows, so the same points under
    another coefficient miss, and a repeat hits."""
    reg, tm, params = family
    eng = PdeServingEngine(reg, slots=2, slot_points=16, device=CPU)
    eng.warmup("fam")
    assert eng.stats["compiles"] == 1
    fill = eng._fill_point("fam")
    tm.problem.coeff_spec.check_in_range(fill[tm.in_dim:])
    pts = _rows("black-scholes-8d-rs", 21, seed=3)[:, :9]
    outs = []
    for c in ([0.02, 0.25], [0.05, 0.4], [0.09, 0.55], [0.03, 0.59]):
        req = eng.submit(PointRequest("fam", pts, coeffs=c))
        eng.run()
        assert req.done and req.points.shape == (21, 11)
        with torch.no_grad():
            direct = tm.u(params, tm.problem.attach_coeffs(
                torch.tensor(pts), c)).numpy()
        assert _within_ulp(req.out, direct)
        outs.append(req.out.copy())
    stats = eng.serving_stats()
    assert stats["programs"] == ["fam|float32|c2|2|16"]
    assert eng.stats["compiles"] == 1          # no rebuild after warm-up
    assert stats["cache_hits"] == 0 and stats["cache_misses"] == 4 * 21
    assert not np.allclose(outs[0], outs[2])
    again = eng.submit(PointRequest("fam", pts, coeffs=[0.05, 0.4]))
    assert again.done and np.array_equal(again.out, outs[1])
    assert eng.stats["cache_hits"] == 21


def test_conditioned_checkpoint_roundtrip_restores_trained_ranges(tmp_path):
    """A port checkpoint trained with ``--coeff-range`` loads with those
    ranges (not the registry's) and serves them within an ulp of the
    trainer's own u; a JAX-written conditioned checkpoint loads with its
    ranges and serves JAX's values."""
    res = train.main(CLI + ["--pde", "black-scholes-8d-rs", "--pinn-noise",
                            "--coeff-range", "r=0.02:0.08", "--steps", "2",
                            "--ckpt-dir", str(tmp_path / "port")])
    reg = SolverRegistry(device=CPU)
    s = reg.load_checkpoint("bs", tmp_path / "port", device=CPU)
    assert s.coeff_spec == tpde.CoeffSpec(("r", "sigma"), (0.02, 0.2),
                                          (0.08, 0.6))
    eng = PdeServingEngine(reg, slots=2, slot_points=16, device=CPU)
    pts = _rows("black-scholes-8d-rs", 19, seed=5)[:, :9]
    with pytest.raises(ValueError, match="r=0.09 outside trained range"):
        eng.submit(PointRequest("bs", pts, coeffs=[0.09, 0.3]))
    req = eng.submit(PointRequest("bs", pts, coeffs=[0.05, 0.3]))
    eng.run()
    with torch.no_grad():
        direct = res.model.u(res.params, res.model.problem.attach_coeffs(
            torch.tensor(pts), [0.05, 0.3]), res.hw_noise).numpy()
    assert _within_ulp(req.out, direct)

    from repro.checkpoint import save_checkpoint as jax_save
    cfg, jm, params, _, _ = _pair("heat-10d-kappa")
    spec = jm.problem.coeff_spec.with_ranges({"kappa": (0.8, 1.2)},
                                             dist="loguniform")
    jax_save(tmp_path / "jax", 3, {"params": params},
             {"pinn": jpinn.config_to_meta(cfg), "pde": "heat-10d-kappa",
              "seed": 0, "coeff_spec": spec.to_meta(),
              "term_weights": {"residual": 1.0, "boundary": 1.0}})
    js = reg.load_checkpoint("heat", tmp_path / "jax", device=CPU)
    assert js.coeff_spec.to_meta() == spec.to_meta()
    jm.problem.coeff_spec = spec
    heat_pts = _rows("heat-10d", 9, seed=6)
    req = eng.submit(PointRequest("heat", heat_pts, coeffs=[1.1]))
    eng.run()
    want = np.asarray(jm.u(params, jm.problem.attach_coeffs(
        jnp.asarray(heat_pts), jnp.asarray([1.1], jnp.float32))))
    assert _relmax(req.out, want) <= U_RTOL


def test_serve_pde_cli_serves_a_conditioned_checkpoint(tmp_path, capsys):
    """``launch.serve_pde --synthetic`` on a conditioned checkpoint: each
    request carries one coefficient vector from the trained ranges, and
    one ``c2`` program serves them all."""
    from repro_torch.launch import serve_pde
    train.main(CLI + ["--pde", "black-scholes-8d-rs", "--steps", "1",
                      "--ckpt-dir", str(tmp_path)])
    serve_pde.main(["--ckpt", f"bs={tmp_path}", "--device", CPU,
                    "--synthetic", "6", "--slots", "2", "--slot-points",
                    "64"])
    out = capsys.readouterr().out
    assert "served 6 requests" in out and "1 built" in out
    assert '"bs|float32|c2|2|64"' in out
