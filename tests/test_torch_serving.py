"""The port's serving stack (registry, engine, cache, checkpoints, CLI)
against the JAX package's.

Solvers are built by the JAX package; their params and hardware noise reach
the port as numpy trees (``repro_torch.interop``) or through a checkpoint
written by ``repro.checkpoint.save_checkpoint``.  Query points are made with
numpy from a seed.  Tolerance for served u-values: ``rtol=1e-5, atol=1e-5``
— both sides reassociate the f32 sums of 4 chain steps and take sin from
two libraries.  Everything here runs on the CPU (``device="cpu"``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pde as jpde
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.core import pinn as jpinn
from repro.core.photonic import NoiseModel as JNoise
from repro.serving import PdeServingEngine as JEngine
from repro.serving import PointRequest as JRequest
from repro.serving import SolverRegistry as JRegistry
from repro.serving import StencilCache as JCache
from repro_torch import checkpoint as tckpt
from repro_torch import interop
from repro_torch.core import pinn as tpinn
from repro_torch.launch import serve_pde
from repro_torch.serving import (PdeServingEngine, PointRequest,
                                 SolverRegistry, StencilCache)

RTOL = ATOL = 1e-5
CPU = "cpu"

# name -> (pde, mode, noise): the mixed traffic of benchmarks/serve_pde.py
# plus the paper's noisy tonn solver, at the REDUCED width (hidden 64, L 3)
SOLVERS = {"heat": ("heat-10d", "tt", False),
           "hjb": ("hjb-20d", "tonn", True)}


def _np_tree(tree):
    return None if tree is None else jax.tree.map(np.asarray, tree)


def _cfg(pde, mode, noise, hidden=64, tt_L=3):
    return jpinn.PINNConfig(hidden=hidden, mode=mode, tt_rank=2, tt_L=tt_L,
                            pde=pde, use_fused_kernel=True,
                            noise=JNoise(enabled=noise))


def _jax_model(cfg, seed):
    """A JAX solver made as ``launch/train.py`` makes it."""
    model = jpinn.TensorPinn(cfg)
    key = jax.random.PRNGKey(seed)
    return model, model.init(key), model.sample_noise(
        jax.random.fold_in(key, 99))


def _port_model(cfg):
    return tpinn.TensorPinn(tpinn.config_from_meta(
        json.loads(json.dumps(jpinn.config_to_meta(cfg)))))


def _both_registries():
    jreg, treg = JRegistry(), SolverRegistry(device=CPU)
    for seed, (name, (pde, mode, noise)) in enumerate(SOLVERS.items()):
        cfg = _cfg(pde, mode, noise)
        model, params, hw = _jax_model(cfg, seed)
        jreg.register(name, model, params, hw_noise=hw)
        treg.register(name, _port_model(cfg),
                      interop.params_from_numpy(_np_tree(params), CPU),
                      hw_noise=interop.noise_from_numpy(_np_tree(hw), CPU))
    return jreg, treg


def _traffic(treg, n_requests=9, pool=48, seed=0):
    """Mixed requests of 1..40 points, one larger than the pool, and an
    exact repeat of the first request (a cache hit)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_requests):
        name = ("heat", "hjb")[i % 2]
        n = int(rng.randint(1, 41))
        out.append((name, rng.uniform(0.02, 0.98, (n, treg.get(name).in_dim))
                    .astype(np.float32)))
    out.append(("hjb", rng.uniform(0.02, 0.98, (pool + 13, 21))
                .astype(np.float32)))
    out.append(out[0])
    return out


def test_mixed_engine_matches_jax_engine():
    jreg, treg = _both_registries()
    jeng = JEngine(jreg, slots=3, slot_points=16)
    teng = PdeServingEngine(treg, slots=3, slot_points=16, device=CPU)
    traffic = _traffic(treg, pool=3 * 16)
    jreqs = [jeng.submit(JRequest(n, p)) for n, p in traffic[:-1]]
    treqs = [teng.submit(PointRequest(n, p)) for n, p in traffic[:-1]]
    jeng.run()
    teng.run()
    # the exact repeat is answered from the cache at submit
    runs = teng.stats["program_runs"]
    jreqs.append(jeng.submit(JRequest(*traffic[-1])))
    treqs.append(teng.submit(PointRequest(*traffic[-1])))
    assert treqs[-1].done and teng.stats["program_runs"] == runs
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.out.shape == (len(tr.points),)
        np.testing.assert_allclose(tr.out, jr.out, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(treqs[-1].out, treqs[0].out)
    # the request larger than the pool spanned steps and completed
    assert len(treqs[-2].points) > 3 * 16 and treqs[-2].done
    # one program per solver, and the same admission as the JAX engine
    assert teng.stats["compiles"] == 2
    assert teng.stats["cache_hits"] == len(traffic[0][1])
    for key in ("compiles", "steps", "program_runs", "points_served",
                "points_padded", "requests_done", "peak_active_slots",
                "cache_hits", "cache_misses", "cache_evictions"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.serving_stats()["programs"] == \
        jeng.serving_stats()["programs"]


def test_served_equals_direct_forward_and_pad_invariance():
    _, treg = _both_registries()
    teng = PdeServingEngine(treg, slots=2, slot_points=32, device=CPU)
    teng.warmup()
    assert teng.stats["compiles"] == 2
    pts = np.random.RandomState(3).uniform(0.02, 0.98, (41, 21)).astype(
        np.float32)
    req = teng.submit(PointRequest("hjb", pts))
    teng.run()
    s = treg.get("hjb")
    with torch.no_grad():
        direct = s.model.u(s.params, torch.tensor(pts)).numpy()
    np.testing.assert_allclose(req.out, direct, rtol=1e-6, atol=1e-6)
    assert teng.stats["compiles"] == 2      # no rebuild after warmup
    # a program takes the full pool only, as the AOT executable does
    program = teng._program("hjb")
    with pytest.raises(ValueError, match="pool"):
        program(torch.zeros((5, 21)))
    with pytest.raises(ValueError, match="pool"):
        program(torch.zeros((64, 21), dtype=torch.float64))


def test_unported_requests_raise():
    _, treg = _both_registries()
    teng = PdeServingEngine(treg, slots=2, slot_points=8, device=CPU)
    pts = np.full((3, 11), 0.5, np.float32)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        teng.submit(PointRequest("heat", pts, dtype=jnp.bfloat16))
    with pytest.raises(ValueError, match="coeff"):
        teng.submit(PointRequest("heat", pts, coeffs=[1.0]))
    with pytest.raises(KeyError):
        teng.submit(PointRequest("nope", pts))
    with pytest.raises(ValueError):
        teng.submit(PointRequest("heat", np.zeros((4, 3), np.float32)))
    with pytest.raises(ValueError):
        teng.submit(PointRequest("heat", np.zeros((0, 11), np.float32)))
    assert not teng.queue


# ----------------------------------------------------------- checkpoints

def _save_jax_ckpt(tmp_path, cfg, seed, step=5, extra=None):
    """A checkpoint as ``launch/train.py`` writes it: params and ZO state,
    with the solver's config, PDE name, seed and loss weights in meta."""
    model, params, hw = _jax_model(cfg, seed)
    meta = {"pinn": jpinn.config_to_meta(cfg), "pde": model.problem.name,
            "seed": seed, "term_weights": model.problem.term_weights()}
    meta.update(extra or {})
    jax_save(tmp_path, step, {"params": params,
                              "zo": {"key": jax.random.PRNGKey(seed)}}, meta)
    return model, params, hw


@pytest.mark.parametrize("pde,mode,noise", [("heat-10d", "tt", False),
                                            ("hjb-20d", "tonn", False),
                                            ("hjb-20d", "tonn", True)])
def test_jax_checkpoint_loads_and_serves_jax_values(tmp_path, pde, mode,
                                                    noise):
    cfg = _cfg(pde, mode, noise)
    model, params, hw = _save_jax_ckpt(tmp_path, cfg, seed=4)
    reg = SolverRegistry(device=CPU)
    s = reg.load_checkpoint("s", tmp_path, hw_noise=_np_tree(hw), device=CPU)
    assert s.step == 5 and s.problem.name == pde
    assert s.model.cfg == tpinn.config_from_meta(jpinn.config_to_meta(cfg))
    pts = np.random.RandomState(1).uniform(
        0.02, 0.98, (37, model.problem.in_dim)).astype(np.float32)
    eng = PdeServingEngine(reg, slots=2, slot_points=16, device=CPU)
    req = eng.submit(PointRequest("s", pts))
    eng.run()
    want = np.asarray(model.u(params, jnp.asarray(pts), hw))
    np.testing.assert_allclose(req.out, want, rtol=RTOL, atol=ATOL)


def test_checkpoints_the_port_cannot_rebuild_raise(tmp_path):
    # noise on: JAX's threefry draws cannot be regenerated from the seed
    _save_jax_ckpt(tmp_path / "noisy", _cfg("hjb-20d", "tonn", True), 0)
    reg = SolverRegistry(device=CPU)
    with pytest.raises(ValueError, match="hw_noise"):
        reg.load_checkpoint("noisy", tmp_path / "noisy", device=CPU)
    # coefficient ranges in meta for a PDE that is not conditioned
    spec = jpde.get_problem("heat-10d-kappa").coeff_spec
    _save_jax_ckpt(tmp_path / "fam", _cfg("heat-10d", "tt", False), 0,
                   extra={"coeff_spec": spec.to_meta()})
    with pytest.raises(ValueError, match="not coefficient-conditioned"):
        reg.load_checkpoint("fam", tmp_path / "fam", device=CPU)
    # a pre-metadata checkpoint needs cfg=
    cfg = _cfg("hjb-10d", "tt", False)
    model = jpinn.TensorPinn(cfg)
    jax_save(tmp_path / "old", 1, {"params": model.init(
        jax.random.PRNGKey(0))})
    with pytest.raises(ValueError, match="pinn"):
        reg.load_checkpoint("old", tmp_path / "old", device=CPU)
    s = reg.load_checkpoint("old", tmp_path / "old", device=CPU,
                            cfg=tpinn.config_from_meta(
                                jpinn.config_to_meta(cfg)))
    assert s.problem.name == "hjb-10d"
    # hw_noise for a solver without noise is refused too
    with pytest.raises(ValueError, match="hw_noise"):
        reg.load_checkpoint("old2", tmp_path / "old", device=CPU,
                            cfg=s.model.cfg, hw_noise={"pcores0": []})
    assert reg.names() == ("old",)


def test_port_checkpoint_format_reads_in_jax(tmp_path):
    cfg = _cfg("hjb-10d", "tonn", False, hidden=16)
    tm = _port_model(cfg)
    params = tm.init(torch.Generator().manual_seed(0))
    path = tckpt.save_checkpoint(tmp_path, 3, {"params": params},
                                 {"pinn": tpinn.config_to_meta(tm.cfg)})
    assert path.name == "step_000000000003" and (path / "COMMITTED").exists()
    assert tckpt.latest_step(tmp_path) == 3
    meta = tckpt.read_checkpoint_meta(tmp_path)
    assert jpinn.config_from_meta(meta["pinn"]) == cfg
    jm = jpinn.TensorPinn(cfg)
    restored, _ = jax_restore(tmp_path, {"params": jm.init(
        jax.random.PRNGKey(1))})
    back, _ = tckpt.restore_checkpoint(tmp_path, {"params": params})
    flat_j = jax.tree.leaves(restored)
    flat_t = jax.tree.leaves(back, is_leaf=torch.is_tensor)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with pytest.raises(FileNotFoundError):
        tckpt.read_checkpoint_meta(tmp_path / "missing")


def test_tree_from_flat_inverts_checkpoint_paths():
    tree = {"pcores0": [{"u": {"gamma": np.ones(2, np.float32)}},
                        {"v": {"bias": np.zeros(3, np.float32)}}],
            "b0": np.ones(1, np.float32)}
    flat = {"pcores0/0/u/gamma": tree["pcores0"][0]["u"]["gamma"],
            "pcores0/1/v/bias": tree["pcores0"][1]["v"]["bias"],
            "b0": tree["b0"]}
    assert jax.tree.map(np.shape, interop.tree_from_flat(flat)) == \
        jax.tree.map(np.shape, tree)
    with pytest.raises(ValueError, match="list indices"):
        interop.tree_from_flat({"a/0": 1, "a/2": 2})
    with pytest.raises(TypeError, match="float32"):
        interop.params_from_numpy({"w": np.ones(2)}, CPU)


# ------------------------------------------------------------------ cache

def test_stencil_cache_matches_jax_copy():
    pts = np.arange(24.0).reshape(12, 2)
    caches = (StencilCache(capacity=8), JCache(capacity=8))
    outs = []
    for cache in caches:
        keys = cache.keys_for("s", np.float32, pts)
        cache.insert(keys[:8], np.arange(8.0))
        cache.lookup(keys[:2])                  # refresh 0, 1 to MRU
        cache.insert(keys[8:], np.arange(8.0, 12.0))
        hit, vals, miss = cache.lookup(keys)
        outs.append((keys, hit.tolist(), vals.tolist(), miss.tolist(),
                     cache.stats()))
    assert outs[0] == outs[1]
    assert sorted(outs[0][3]) == [2, 3, 4, 5]
    coarse = StencilCache(capacity=4, quantum=1e-3)
    p = np.array([[0.5, 0.5]])
    coarse.insert(coarse.keys_for("s", np.float32, p), np.array([1.25]))
    hit, vals, _ = coarse.lookup(coarse.keys_for("s", np.float32, p + 1e-5))
    assert vals.tolist() == [1.25]
    for other in (coarse.keys_for("s", np.float64, p),
                  coarse.keys_for("t", np.float32, p)):
        assert len(coarse.lookup(other)[2]) == 1
    with pytest.raises(ValueError):
        StencilCache(capacity=0)


# -------------------------------------------------------------------- CLI

def test_serve_pde_cli_serves_jax_checkpoints(tmp_path, capsys):
    _save_jax_ckpt(tmp_path / "heat", _cfg("heat-10d", "tt", False), 0)
    _, _, hw = _save_jax_ckpt(tmp_path / "hjb", _cfg("hjb-20d", "tonn", True),
                              1)
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(hw)[0]}
    np.savez(tmp_path / "hjb-noise.npz", **flat)
    serve_pde.main(["--ckpt", f"heat={tmp_path / 'heat'}",
                    "--ckpt", f"hjb={tmp_path / 'hjb'}",
                    "--hw-noise", f"hjb={tmp_path / 'hjb-noise.npz'}",
                    "--device", "cpu", "--synthetic", "6", "--slots", "2",
                    "--slot-points", "32", "--max-request-points", "40"])
    out = capsys.readouterr().out
    assert "served 6 requests" in out
    stats = json.loads(out[out.index("{"):])
    assert stats["compiles"] == 2 and stats["requests_done"] == 6
    with pytest.raises(SystemExit):
        serve_pde.main(["--ckpt", f"heat={tmp_path / 'heat'}",
                        "--hw-noise", f"other={tmp_path / 'hjb-noise.npz'}",
                        "--device", "cpu", "--synthetic", "1"])
