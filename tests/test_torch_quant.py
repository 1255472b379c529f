"""The port's quantization (``kernels/quant.py``, the quantized plain chains,
the ``quant=`` hooks of ``ops``, and quantized serving) against the JAX
package's; ``test_torch_qat.py`` holds quantization-aware training.

Inputs are made with numpy from a seed, or by the JAX side and handed over
as numpy trees (``repro_torch.interop``).  Tolerances:

  * the quantizer (codes, scales, dequantized and fake-quantized values,
    snapped phases) is held **bit for bit**: both sides divide, round and
    cast the same f32 numbers the same way;
  * quantized chains and served u-values ``rtol = atol = 1e-5``: the
    cores are bit-equal, the f32 sums of the chain are taken in another
    order and sin comes from two libraries.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save
from repro.core import photonic as jph
from repro.core import pinn as jpinn
from repro.core import tt as jtt
from repro.core.photonic import NoiseModel as JNoise
from repro.kernels import ops as jops
from repro.kernels import quant as jq
from repro.kernels import ref as jref
from repro.kernels import tt_contract as jttc
from repro.serving import PdeServingEngine as JEngine
from repro.serving import PointRequest as JRequest
from repro.serving import SolverRegistry as JRegistry
from repro_torch import interop
from repro_torch.core import photonic as tph
from repro_torch.core import pinn as tpinn
from repro_torch.core import tt as ttt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant as tq
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tt_contract as tttc
from repro_torch.serving import PdeServingEngine, PointRequest, SolverRegistry
from test_torch_pinn import share_cores  # noqa: F401 (autouse)

RTOL = ATOL = 1e-5
DTYPES = ("int8", "fp8_e4m3")
CPU = "cpu"


def _configs(dtype, block=32, phase_bits=None):
    """The same quant config in both packages."""
    return (jq.QuantConfig(enabled=True, dtype=dtype, block=block,
                           phase_bits=phase_bits),
            tq.QuantConfig(enabled=True, dtype=dtype, block=block,
                           phase_bits=phase_bits))


def _bits(a) -> np.ndarray:
    """The bytes of an array as unsigned ints (fp8, int8 and f32 alike)."""
    a = np.asarray(a)
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


def _tbits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float8_e4m3fn:
        t = t.view(torch.uint8)
    return _bits(t.numpy())


# ----------------------------------------------------------------- quantizer

@pytest.mark.parametrize("block", [16, 32, 7])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantizer_is_bit_equal_to_jax(dtype, block):
    """Codes, scales, dequantized and fake-quantized values over 11,007
    values (7 does not divide it: a padded tail), with an all-zero block
    and values of every magnitude."""
    rng = np.random.RandomState(block)
    x = (rng.standard_normal(11007) * np.exp(rng.uniform(-8, 8, 11007))
         ).astype(np.float32)
    x[block:2 * block] = 0.0                      # an all-zero block
    jc, tc = _configs(dtype, block)
    q_j, s_j = jq.quantize_blockwise(jnp.asarray(x), jc)
    q_t, s_t = tq.quantize_blockwise(torch.tensor(x), tc)
    assert q_t.dtype == tq.QUANT_DTYPES[dtype][0]
    np.testing.assert_array_equal(_tbits(q_t), _bits(q_j))
    np.testing.assert_array_equal(_tbits(s_t), _bits(s_j))
    assert float(s_t[1]) == 1.0                   # the zero block's scale
    deq_j = jq.dequantize_blockwise(q_j, s_j, (11007,), jc)
    deq_t = tq.dequantize_blockwise(q_t, s_t, (11007,), tc)
    np.testing.assert_array_equal(_tbits(deq_t), _bits(deq_j))
    fq_t = tq.fake_quant(torch.tensor(x).reshape(3, 3669), tc)
    np.testing.assert_array_equal(
        _tbits(fq_t), _bits(jq.fake_quant(jnp.asarray(x).reshape(3, 3669),
                                          jc)))
    # idempotent, as the serving engine's build-time fold relies on
    assert torch.equal(tq.fake_quant(fq_t, tc), fq_t)


@pytest.mark.parametrize("dtype", DTYPES)
def test_stacked_quantizer_is_jax_vmap(dtype):
    """Each row of a core stack is quantized on its own: the stacked form
    equals JAX's vmap and the per-row quantizer, bit for bit."""
    rng = np.random.RandomState(3)
    stack = rng.standard_normal((5, 2, 3, 5, 4)).astype(np.float32)
    stack[2] = 0.0
    stack[4] *= 1e3
    for block in (16, 32):
        jc, tc = _configs(dtype, block)
        q_j, s_j = jax.vmap(lambda c: jq.quantize_blockwise(c, jc))(
            jnp.asarray(stack))
        q_t, s_t = tq.quantize_blockwise_stacked(torch.tensor(stack), tc)
        assert tuple(q_t.shape) == (5, 128) and tuple(s_t.shape) == \
            (5, 128 // block)
        np.testing.assert_array_equal(_tbits(q_t), _bits(q_j))
        np.testing.assert_array_equal(_tbits(s_t), _bits(s_j))
        for p in range(5):
            q1, s1 = tq.quantize_blockwise(torch.tensor(stack[p]), tc)
            np.testing.assert_array_equal(_tbits(q1), _tbits(q_t[p]))
            assert torch.equal(s1, s_t[p])
        fq = tq.fake_quant_stacked(torch.tensor(stack), tc)
        np.testing.assert_array_equal(
            _tbits(fq), _bits(jax.vmap(lambda c: jq.fake_quant(c, jc))(
                jnp.asarray(stack))))
        # padded rows (120 of 128) come back contiguous: the TT kernels
        # take only contiguous cores
        assert fq.is_contiguous()
        assert tq.fake_quant(torch.tensor(stack[1]), tc).is_contiguous()


def test_fp8_cast_matches_jax_at_the_edges():
    """The e4m3 cast alone, on values at and around ±448, subnormals and
    zero, bit for bit."""
    rng = np.random.RandomState(0)
    edge = np.asarray([448.0, -448.0, 448.00003, -448.00003, 447.9, 2e-3,
                       -2e-3, 1e-9, 0.0, -0.0, 0.0019531, 0.0009765],
                      np.float32)
    x = np.concatenate([edge, rng.uniform(-448, 448, 100_000).astype(
        np.float32), rng.uniform(-0.02, 0.02, 20_000).astype(np.float32)])
    np.testing.assert_array_equal(
        _tbits(torch.tensor(x).to(torch.float8_e4m3fn)),
        _bits(jnp.asarray(x).astype(jnp.float8_e4m3fn)))


@pytest.mark.parametrize("bits", [1, 6, 8, 16])
def test_quantize_phases_is_bit_equal_to_jax(bits):
    ph = np.random.RandomState(bits).uniform(-20, 20, (3, 7, 9)).astype(
        np.float32)
    got = tq.quantize_phases(torch.tensor(ph), bits)
    np.testing.assert_array_equal(
        _tbits(got), _bits(jq.quantize_phases(jnp.asarray(ph), bits)))
    assert torch.equal(tq.quantize_phases(got, bits), got)


def test_disabled_or_missing_config_passes_through():
    x = torch.randn(4, 8)
    for cfg in (None, tq.QuantConfig(), tq.QuantConfig(enabled=True,
                                                       dtype=None)):
        assert tq.fake_quant(x, cfg) is x
        assert tq.fake_quant_stacked(x, cfg) is x
    with pytest.raises(ValueError, match="not enabled"):
        tq.quantize_blockwise(x, tq.QuantConfig())


# -------------------------------------------------------------- QuantConfig

QUANT_KWARGS = [dict(), dict(enabled=True), dict(enabled=True, block=16),
                dict(enabled=True, dtype="fp8_e4m3", phase_bits=8),
                dict(enabled=True, dtype=None, phase_bits=6),
                dict(enabled=True, dtype=None),
                dict(enabled=False, dtype="fp8_e4m3", phase_bits=4)]


@pytest.mark.parametrize("kw", QUANT_KWARGS, ids=str)
def test_quant_config_gates_tags_and_bytes_match_jax(kw):
    jc, tc = jq.QuantConfig(**kw), tq.QuantConfig(**kw)
    assert (tc.weights, tc.phases, tc.tag()) == (jc.weights, jc.phases,
                                                 jc.tag())
    assert tq.quantized_bytes_per_param(tc) == \
        jq.quantized_bytes_per_param(jc)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def test_quant_config_tags():
    assert tq.QuantConfig(enabled=True, phase_bits=8).tag() == "int8b32+pb8"
    assert tq.QuantConfig(enabled=True, dtype="fp8_e4m3",
                          block=16).tag() == "fp8_e4m3b16"
    assert tq.QuantConfig(enabled=True, dtype=None).tag() == "noop"
    assert tq.QuantConfig(dtype="fp8_e4m3").tag() == ""
    assert tq.quantized_bytes_per_param(tq.QuantConfig(enabled=True)) == 1.125


@pytest.mark.parametrize("bad", [dict(dtype="int4"), dict(block=0),
                                 dict(block=-3), dict(phase_bits=0),
                                 dict(phase_bits=33)], ids=str)
def test_quant_config_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError) as j_err:
        jq.QuantConfig(enabled=True, **bad)
    with pytest.raises(ValueError) as t_err:
        tq.QuantConfig(enabled=True, **bad)
    assert str(t_err.value) == str(j_err.value)


def test_quant_meta_round_trip_reads_jax_and_rejects_bad_meta():
    jcfg = jpinn.PINNConfig(hidden=16, mode="tonn", tt_L=3,
                            quant=jq.QuantConfig(enabled=True,
                                                 dtype="fp8_e4m3", block=16,
                                                 phase_bits=6))
    meta = json.loads(json.dumps(jpinn.config_to_meta(jcfg)))
    tcfg = tpinn.config_from_meta(meta)
    assert isinstance(tcfg.quant, tq.QuantConfig)
    assert tcfg.quant.tag() == "fp8_e4m3b16+pb6"
    assert tpinn.config_to_meta(tcfg) == meta
    for key, value in (("dtype", "int4"), ("block", 0), ("phase_bits", 40)):
        bad = json.loads(json.dumps(meta))
        bad["quant"][key] = value
        with pytest.raises(ValueError):
            jpinn.config_from_meta(bad)
        with pytest.raises(ValueError):
            tpinn.config_from_meta(bad)


# ------------------------------------------------------------ plain chains

RANK4 = jtt.auto_factorize(256, 512, L=3, max_rank=4)

# label -> (spec, P, x shape without P, shared x, block): the paper's spec
# (core sizes 64, no padding at block 32), and a rank-4 spec whose core
# sizes are not block multiples (padded tails) at blocks 32 and 16
QCHAIN_CASES = {
    "paper-shared": (jtt.PAPER_TONN_SPEC, 3, (5,), True, 32),
    "paper-per-entry": (jtt.PAPER_TONN_SPEC, 3, (4,), False, 32),
    "rank4-b32": (RANK4, 3, (7,), False, 32),
    "rank4-b16-shared-axes": (RANK4, 2, (2, 3), True, 16),
}


def _port_spec(spec):
    return ttt.TTSpec(spec.out_modes, spec.in_modes, spec.ranks)


def _stack_inputs(spec, P, x_shape, shared, seed):
    rng = np.random.RandomState(seed)
    cores = [rng.standard_normal((P, *s)).astype(np.float32) * 0.5
             for s in spec.core_shapes]
    cores[0][0, 0] = 0.0                     # an all-zero run of values
    lead = () if shared else (P,)
    x = rng.standard_normal((*lead, *x_shape, spec.in_dim)).astype(np.float32)
    return cores, x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("label", sorted(QCHAIN_CASES))
def test_batched_quant_plain_version_matches_jax(label, dtype):
    """``tt_contract_batched_quant_ref`` against JAX's plain version and
    against JAX's quantized Pallas kernel in interpret mode."""
    spec, P, x_shape, shared, block = QCHAIN_CASES[label]
    cores, x = _stack_inputs(spec, P, x_shape, shared, seed=len(label))
    jc, tc = _configs(dtype, block)
    jcores = [jnp.asarray(c) for c in cores]
    want_ref = np.asarray(jref.tt_contract_batched_quant_ref(
        jnp.asarray(x), jcores, spec, jc, shared_x=shared))
    want_kernel = np.asarray(jttc.tt_contract_batched_quant(
        jnp.asarray(x), tuple(jcores), spec, jc, interpret=True,
        shared_x=shared))
    tcores = [torch.tensor(c) for c in cores]
    got = tref.tt_contract_batched_quant_ref(torch.tensor(x), tcores,
                                             _port_spec(spec), tc, shared)
    assert tuple(got.shape) == (P, *x_shape, spec.out_dim)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=RTOL, atol=ATOL)
    # it is the f32 plain chain on the fake-quantized stacks
    fq = [tq.fake_quant_stacked(c, tc) for c in tcores]
    assert torch.equal(got, tref.tt_contract_batched_ref(
        torch.tensor(x), fq, _port_spec(spec), shared))
    # ... and through ops on the CPU
    assert torch.equal(got, tops.tt_linear_batched(
        torch.tensor(x), tcores, _port_spec(spec), quant=tc, shared_x=shared))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_tt_linear_quant_matches_jax(mode, dtype):
    spec = RANK4
    rng = np.random.RandomState(7)
    cores = [rng.standard_normal(s).astype(np.float32) * 0.3 for s in
             spec.core_shapes]
    x = rng.standard_normal((3, 4, spec.in_dim)).astype(np.float32)
    jc, tc = _configs(dtype, 16)
    want = np.asarray(jops.tt_linear(jnp.asarray(x),
                                     [jnp.asarray(c) for c in cores], spec,
                                     mode=mode, quant=jc))
    tcores = [torch.tensor(c) for c in cores]
    got = tops.tt_linear(torch.tensor(x), tcores, _port_spec(spec), quant=tc)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # it is the f32 plain chain on the fake-quantized cores
    assert torch.equal(got, tref.tt_contract_ref(
        torch.tensor(x), [tq.fake_quant(c, tc) for c in tcores],
        _port_spec(spec)))


def test_ops_with_quant_off_are_the_unquantized_paths():
    spec = _port_spec(jtt.PAPER_TONN_SPEC)
    cores, x = _stack_inputs(jtt.PAPER_TONN_SPEC, 2, (3,), True, seed=1)
    tcores = [torch.tensor(c) for c in cores]
    plain = tops.tt_linear_batched(torch.tensor(x), tcores, spec)
    single = tops.tt_linear(torch.tensor(x), [c[0] for c in tcores], spec)
    for off in (None, tq.QuantConfig(),
                tq.QuantConfig(enabled=True, dtype=None, phase_bits=8)):
        assert torch.equal(tops.tt_linear_batched(
            torch.tensor(x), tcores, spec, quant=off), plain)
        assert torch.equal(tops.tt_linear(
            torch.tensor(x), [c[0] for c in tcores], spec, quant=off), single)


def test_quant_wrapper_refuses_cpu_tensors_and_quant_off():
    """The kernel wrapper launches on CUDA tensors only, with weight
    quantization on; it never runs the plain version itself."""
    spec = _port_spec(jtt.PAPER_TONN_SPEC)
    cores = [torch.zeros((3, *s)) for s in spec.core_shapes]
    _, tc = _configs("int8")
    before = tttc.tt_contract_batched_quant.launches
    with pytest.raises(ValueError, match="CUDA"):
        tttc.tt_contract_batched_quant(torch.zeros(4, 1024), cores, spec, tc)
    with pytest.raises(ValueError, match="not enabled"):
        tttc.tt_contract_batched_quant(torch.zeros(4, 1024), cores, spec,
                                       tq.QuantConfig(enabled=True,
                                                      dtype=None))
    with pytest.raises(ValueError, match="CUDA"):
        tops.tt_linear_batched(torch.zeros(4, 1024, device="meta"),
                               [c.to("meta") for c in cores], spec, quant=tc)
    assert tttc.tt_contract_batched_quant.launches == before


# --------------------------------------------------------------- serving

def _np_tree(tree):
    return None if tree is None else jax.tree.map(np.asarray, tree)


def _port_model(cfg):
    return tpinn.TensorPinn(tpinn.config_from_meta(
        json.loads(json.dumps(jpinn.config_to_meta(cfg)))))


def _points(n, width, seed):
    return np.random.RandomState(seed).uniform(
        0.02, 0.98, (n, width)).astype(np.float32)


def _save_jax_ckpt(path, cfg, seed):
    model = jpinn.TensorPinn(cfg)
    key = jax.random.PRNGKey(seed)
    params = model.init(key)
    meta = {"pinn": jpinn.config_to_meta(cfg), "pde": model.problem.name,
            "seed": seed, "term_weights": model.problem.term_weights()}
    jax_save(path, 3, {"params": params, "zo": {"key": key}}, meta)
    return model, params


@pytest.mark.parametrize("mode,qkw", [
    ("tt", dict(enabled=True)),
    ("tonn", dict(enabled=True, dtype="fp8_e4m3", phase_bits=6))])
def test_jax_quantized_checkpoint_serves_jax_values(tmp_path, mode, qkw):
    """A JAX-written quantized checkpoint loads in the port's registry
    (DAC snap at load for tonn) and serves JAX's quantized u."""
    cfg = jpinn.PINNConfig(hidden=64, mode=mode, tt_rank=2, tt_L=3,
                           pde="hjb-20d", use_fused_kernel=True,
                           quant=jq.QuantConfig(**qkw))
    model, params = _save_jax_ckpt(tmp_path, cfg, seed=2)
    reg = SolverRegistry(device=CPU)
    s = reg.load_checkpoint("q", tmp_path, device=CPU)
    assert s.model.cfg.quant == tq.QuantConfig(**qkw)
    pts = _points(37, 21, seed=4)
    eng = PdeServingEngine(reg, slots=2, slot_points=16, device=CPU)
    req = eng.submit(PointRequest("q", pts))
    eng.run()
    want = np.asarray(model.u(params, jnp.asarray(pts)))
    np.testing.assert_allclose(req.out, want, rtol=RTOL, atol=ATOL)
    # the quantized solver differs from its f32 twin
    f32 = np.asarray(jpinn.TensorPinn(dataclasses.replace(
        cfg, quant=jq.QuantConfig())).u(params, jnp.asarray(pts)))
    assert np.abs(req.out - f32).max() > 1e-4


@pytest.mark.parametrize("request_quant", ["phase_bits_only", "f32"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantized_checkpoint_serves_requests_as_the_jax_engine(
        tmp_path, dtype, request_quant):
    """A weight-quantized tt checkpoint served to a request without weight
    quantization: the request's config replaces the solver's (unquantized
    cores), as in the JAX engine; an f32 request keeps the solver's own."""
    cfg = jpinn.PINNConfig(hidden=64, mode="tt", tt_rank=2, tt_L=3,
                           pde="hjb-20d", use_fused_kernel=True,
                           quant=jq.QuantConfig(enabled=True, dtype=dtype))
    model, params = _save_jax_ckpt(tmp_path, cfg, seed=5)
    jreg, treg = JRegistry(), SolverRegistry(device=CPU)
    jreg.load_checkpoint("q", tmp_path)
    treg.load_checkpoint("q", tmp_path, device=CPU)
    jeng = JEngine(jreg, slots=2, slot_points=16)
    teng = PdeServingEngine(treg, slots=2, slot_points=16, device=CPU)
    jc, tc = ((None, None) if request_quant == "f32"
              else _configs(None, phase_bits=8))
    pts = _points(29, 21, seed=6)
    jr = jeng.submit(JRequest("q", pts, quant=jc))
    tr = teng.submit(PointRequest("q", pts, quant=tc))
    jeng.run()
    teng.run()
    np.testing.assert_allclose(tr.out, jr.out, rtol=RTOL, atol=ATOL)
    assert teng.serving_stats()["programs"] == \
        jeng.serving_stats()["programs"]
    f32_cfg = dataclasses.replace(cfg, quant=jq.QuantConfig())
    want_cfg = f32_cfg if request_quant == "phase_bits_only" else cfg
    want = np.asarray(jpinn.TensorPinn(want_cfg).u(params, jnp.asarray(pts)))
    np.testing.assert_allclose(tr.out, want, rtol=RTOL, atol=ATOL)


def _both_engines():
    """The JAX and port registries over the same hjb (tonn, noise) and
    heat (tt) solvers, at the reduced width."""
    jreg, treg = JRegistry(), SolverRegistry(device=CPU)
    for seed, (name, pde, mode, noise) in enumerate(
            [("heat", "heat-10d", "tt", False),
             ("hjb", "hjb-20d", "tonn", True)]):
        cfg = jpinn.PINNConfig(hidden=64, mode=mode, tt_rank=2, tt_L=3,
                               pde=pde, use_fused_kernel=True,
                               noise=JNoise(enabled=noise))
        model = jpinn.TensorPinn(cfg)
        key = jax.random.PRNGKey(seed)
        params = model.init(key)
        hw = model.sample_noise(jax.random.fold_in(key, 99))
        jreg.register(name, model, params, hw_noise=hw)
        treg.register(name, _port_model(cfg),
                      interop.params_from_numpy(_np_tree(params), CPU),
                      hw_noise=interop.noise_from_numpy(_np_tree(hw), CPU))
    return (JEngine(jreg, slots=3, slot_points=16),
            PdeServingEngine(treg, slots=3, slot_points=16, device=CPU))


def test_quantized_requests_match_the_jax_engine():
    """f32, int8 and fp8 requests mixed in one burst: the same values,
    programs, admission and cache counters as the JAX engine's."""
    jeng, teng = _both_engines()
    rng = np.random.RandomState(0)
    quants = [None, ("int8", 32), ("fp8_e4m3", 16)]
    traffic = []
    for i in range(9):
        name = ("heat", "hjb")[i % 2]
        width = 11 if name == "heat" else 21
        traffic.append((name, rng.uniform(0.02, 0.98, (
            int(rng.randint(1, 30)), width)).astype(np.float32),
            quants[i % 3]))

    def cfgs(q):
        return (None, None) if q is None else _configs(q[0], q[1])

    jreqs = [jeng.submit(JRequest(n, p, quant=cfgs(q)[0]))
             for n, p, q in traffic]
    treqs = [teng.submit(PointRequest(n, p, quant=cfgs(q)[1]))
             for n, p, q in traffic]
    jeng.run()
    teng.run()
    for jr, tr in zip(jreqs, treqs):
        assert tr.done
        np.testing.assert_allclose(tr.out, jr.out, rtol=RTOL, atol=ATOL)
    for key in ("compiles", "steps", "program_runs", "points_served",
                "points_padded", "requests_done", "cache_hits",
                "cache_misses"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.serving_stats()["programs"] == \
        jeng.serving_stats()["programs"]
    assert teng.stats["compiles"] == 6      # 2 solvers x {f32, int8, fp8}


def test_quantized_programs_are_built_once_and_cache_is_isolated():
    _, teng = _both_engines()
    treg = teng.registry
    _, int8 = _configs("int8")
    pts = _points(20, 21, seed=1)
    f32_req = teng.submit(PointRequest("hjb", pts))
    q_req = teng.submit(PointRequest("hjb", pts, quant=int8))
    teng.run()
    assert teng.stats["compiles"] == 2
    assert teng.stats["cache_hits"] == 0    # the same points, another tag
    assert np.abs(q_req.out - f32_req.out).max() > 1e-4
    # f32 values are the f32 model's, with quantized traffic in flight
    # (1e-6: the head's matmul may block another number of rows otherwise)
    s = treg.get("hjb")
    with torch.no_grad():
        np.testing.assert_allclose(
            f32_req.out, s.model.u(s.params, torch.tensor(pts)).numpy(),
            rtol=1e-6, atol=1e-6)
    # a repeat of each is answered from its own cache entries
    runs = teng.stats["program_runs"]
    for quant, want in ((None, f32_req.out), (int8, q_req.out)):
        again = teng.submit(PointRequest("hjb", pts, quant=quant))
        assert again.done
        np.testing.assert_array_equal(again.out, want)
    assert teng.stats["program_runs"] == runs
    # an equal config is the same program; a new block size is another
    teng.submit(PointRequest("hjb", _points(3, 21, seed=2),
                             quant=tq.QuantConfig(enabled=True)))
    teng.submit(PointRequest("hjb", _points(3, 21, seed=2),
                             quant=_configs("int8", 16)[1]))
    teng.run()
    assert teng.stats["compiles"] == 3
    assert "hjb|float32|int8b32|3|16" in teng.serving_stats()["programs"]


def test_program_build_fake_quant_equals_per_call_fake_quant():
    """The engine fake-quantizes the frozen cores once, at program build;
    that program gives the same bits as a model with the quant hooks on,
    which fake-quantizes them on every call."""
    _, teng = _both_engines()
    treg = teng.registry
    for name, width in (("hjb", 21), ("heat", 11)):
        for dtype in DTYPES:
            _, qc = _configs(dtype)
            s = treg.get(name)
            qmodel = tpinn.TensorPinn(dataclasses.replace(s.model.cfg,
                                                          quant=qc),
                                      problem=s.model.problem)
            pool = torch.tensor(_points(48, width, seed=len(dtype)))
            with torch.no_grad():
                assert torch.equal(teng._program(name, qc)(pool),
                                   qmodel.u(s.params, pool))
            req = teng.submit(PointRequest(name, pool[:13].numpy(),
                                           quant=qc))
            teng.run()
            with torch.no_grad():
                direct = qmodel.u(s.params, pool[:13]).numpy()
            np.testing.assert_allclose(req.out, direct, rtol=1e-6,
                                       atol=1e-6)
