"""The port's LM stack (``repro_torch.models``, ``launch.serve``) against the
JAX package's (``repro.models.api`` in ``"ref"`` kernel mode, whose
attention is ``models/flash.py::flash_attention_hlo``), at the reduced
configs, from the same params (JAX's, converted leaf by leaf with
``interop.lm_params_from_numpy``) and the same tokens.

Tolerances: f32 logits and caches within ``1e-5`` of their max magnitude
(the same math with sums in other orders; measured ≤ 1e-6); bf16 logits
within ``2e-2`` of max|logit| (``tests/test_arch_smoke.py``'s bar: bf16
rounds at other places in the two frameworks).  Tokens are compared only
where the port's top-2 logit gap exceeds 100× the f32 tolerance, which the
test asserts, so a near-tie cannot flip a token.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServingEngine as JEngine
from repro.models import api as japi
from repro.models import layers as jlayers
from repro_torch import configs, interop
from repro_torch.core import zoo
from repro_torch.device import counter_generator
from repro_torch.launch import serve
from repro_torch.models import api, layers, transformer
from test_torch_pinn import share_cores  # noqa: F401 (autouse)

CPU = torch.device("cpu")
DENSE = [a for a in configs.ARCH_NAMES
         if configs.get_config(a).family == "dense"]
UNPORTED = [a for a in configs.ARCH_NAMES if a not in DENSE]
RTOL = 1e-5


def _close(got: torch.Tensor, want, rtol: float = RTOL) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + 1e-7, err


@functools.cache
def _model(arch: str, dtype: str = "float32"):
    """JAX params of the reduced config (seed 0) and their conversion."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype=dtype)
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype=dtype)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), CPU)
    return jcfg, cfg, jparams, params


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ------------------------------------------------------------------ configs

def test_arch_names_and_shapes_match_jax():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in api.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in japi.SHAPES.items()}


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_configs_match_jax_field_for_field(arch, reduced):
    get = "get_reduced" if reduced else "get_config"
    cfg, jcfg = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for prop in ("resolved_head_dim", "d_inner", "ssm_heads", "expert_d_ff"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.param_count_estimate() == jcfg.param_count_estimate()
    assert cfg.active_param_count_estimate() == \
        jcfg.active_param_count_estimate()
    for i in range(cfg.num_layers):
        assert (cfg.layer_kind(i), cfg.ffn_kind(i), cfg.uses_swa(i)) == \
            (jcfg.layer_kind(i), jcfg.ffn_kind(i), jcfg.uses_swa(i))


def test_qwen_full_width_is_3b():
    cfg = configs.get_config("qwen2.5-3b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (36, 2048, 16, 2, 128, 11008, 151936)
    assert 3.0e9 < cfg.param_count_estimate() < 3.2e9


# ------------------------------------------------------- forward / prefill

@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_jax(arch):
    """forward on S+1 tokens, prefill on S, one decode step of token S —
    logits, caches and positions against JAX's.  h2o-danube runs past its
    reduced window (64) so the sliding window bites."""
    jcfg, cfg, jparams, params = _model(arch)
    B, S = 2, (80 if cfg.sliding_window else 16)
    toks = _tokens(cfg, B, S + 1)
    t = torch.from_numpy(toks).long()
    j_full = japi.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    _close(api.forward(params, cfg, {"tokens": t}), j_full)

    j_logits, j_cache = japi.prefill_fn(jparams, jcfg,
                                        {"tokens": jnp.asarray(toks[:, :S])})
    logits, cache = transformer.prefill(params, cfg, t[:, :S], max_len=S + 1)
    _close(logits, j_logits)
    assert cache["pos"] == int(j_cache["pos"]) == S
    for key in ("k_0", "v_0"):
        assert cache[key].shape[:3] == j_cache[key].shape[:3]
        _close(cache[key][:, :, :, :S], j_cache[key])
        assert not cache[key][:, :, :, S:].any()

    pad = ((0, 0),) * 3 + ((0, 1), (0, 0))            # room for token S
    j_cache = {k: (jnp.pad(v, pad) if k != "pos" else v)
               for k, v in j_cache.items()}
    j_dec, j_cache2 = japi.decode_fn(jparams, jcfg, j_cache,
                                     jnp.asarray(toks[:, S:]))
    dec, cache2 = api.decode_fn(params, cfg, cache, t[:, S:])
    _close(dec, j_dec)
    _close(dec[:, 0], np.asarray(j_full)[:, S])
    assert cache2["pos"] == int(j_cache2["pos"]) == S + 1
    for key in ("k_0", "v_0"):
        _close(cache2[key], j_cache2[key])


@pytest.mark.parametrize("arch", DENSE)
def test_reduced_prefill_decode_consistency(arch):
    """``tests/test_arch_smoke.py``'s check on the port alone: prefill of
    t_0..t_{n−1}, then decode of t_n, equals forward of t_0..t_n at the
    last two positions (f32 here, so at RTOL, not 2e-2)."""
    _, cfg, _, params = _model(arch)
    B, S = 2, 16
    t = torch.from_numpy(_tokens(cfg, B, S + 1, seed=1)).long()
    full = api.forward(params, cfg, {"tokens": t})
    pre, cache = api.prefill_fn(params, cfg, {"tokens": t[:, :S]})
    _close(pre[:, -1], full[:, S - 1].numpy())
    pad = (0, 0, 0, 1)                                 # seq axis of k_0/v_0
    cache = {k: (torch.nn.functional.pad(v, pad) if k != "pos" else v)
             for k, v in cache.items()}
    dec, cache2 = api.decode_fn(params, cfg, cache, t[:, S:])
    _close(dec[:, -1], full[:, S].numpy())
    assert cache2["pos"] == S + 1


def test_decode_past_the_cache_clamps_as_jax():
    """Writes past ``max_len`` land in the last slot (JAX's
    ``dynamic_update_slice`` clamps); the logits keep following JAX's."""
    jcfg, cfg, jparams, params = _model("qwen2.5-3b")
    toks = _tokens(cfg, 2, 6, seed=2)
    j_cache = japi.init_cache(jcfg, 2, 4)
    cache = api.init_cache(cfg, 2, 4, device="cpu")
    for i in range(6):
        j_lg, j_cache = japi.decode_fn(jparams, jcfg, j_cache,
                                       jnp.asarray(toks[:, i:i + 1]))
        lg, cache = api.decode_fn(params, cfg, cache,
                                  torch.from_numpy(toks[:, i:i + 1]).long())
        _close(lg, j_lg)
    _close(cache["k_0"], j_cache["k_0"])


def test_bf16_model_matches_jax():
    """The full configs run in bf16: a bf16 reduced qwen against JAX's
    bf16 forward, within test_arch_smoke's 2e-2 of max|logit|."""
    jcfg, cfg, jparams, params = _model("qwen2.5-3b", "bfloat16")
    assert params["layers_0"]["mlp"]["w_up"]["w"].dtype == torch.bfloat16
    toks = _tokens(cfg, 2, 24, seed=3)
    want = japi.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got = api.forward(params, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert got.dtype == torch.bfloat16
    _close(got, want.astype(jnp.float32), rtol=2e-2)


# ------------------------------------------------------------------ layers

def test_mrope_with_distinct_streams_matches_jax():
    """M-RoPE with three different position streams (the text path feeds
    one stream three times)."""
    cfg = configs.get_reduced("qwen2-vl-2b")
    pos = np.random.default_rng(4).integers(0, 500, (3, 2, 7)).astype(
        np.int32)
    cos, sin = layers.rope_freqs(cfg, torch.from_numpy(pos).long())
    j_cos, j_sin = jlayers.rope_freqs(jconfigs.get_reduced("qwen2-vl-2b"),
                                      jnp.asarray(pos))
    _close(cos, j_cos)
    _close(sin, j_sin)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_jax(window):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 4, 1, 8), dtype=np.float32)
    k = rng.standard_normal((2, 2, 12, 8), dtype=np.float32)
    v = rng.standard_normal((2, 2, 12, 8), dtype=np.float32)
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 9, window)
    got = layers.decode_attention(*map(torch.from_numpy, (q, k, v)), 9,
                                  window)
    _close(got, want)


# ------------------------------------------------------------------ interop

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_from_numpy_keeps_dtypes_and_bits(dtype):
    jcfg, cfg, jparams, params = _model("qwen2.5-3b", dtype)
    j_leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(j_leaves) == len(zoo.tree_leaves(params))
    for path, leaf in j_leaves:
        node = params
        for key in path:
            node = node[key.key]
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert params["embed"]["table"].dtype == layers.dtype_of(cfg)


def test_init_params_has_jax_layout():
    """The port's own init: the JAX tree's keys, shapes and dtypes."""
    for arch in ("qwen2.5-3b", "starcoder2-7b"):
        jcfg, cfg, jparams, _ = _model(arch)
        own = api.init_params(cfg, counter_generator(0), "cpu")
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).split(".")[-1]), own)
        assert got == want


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_families_raise_naming_their_item(arch):
    cfg = configs.get_reduced(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 14"):
        api.init_params(cfg, counter_generator(0), "cpu")


@pytest.mark.parametrize("tt_mode", ["embedding", "all"])
def test_tt_compressed_lm_raises(tt_mode):
    cfg = dataclasses.replace(configs.get_reduced("qwen2.5-3b"),
                              tt_mode=tt_mode)
    with pytest.raises(NotImplementedError, match="item 14e"):
        api.init_params(cfg, counter_generator(0), "cpu")


# ------------------------------------------------------------------ serving

def test_serving_engine_matches_jax_engine():
    """Three requests on two slots, as the JAX engine serves them: one
    admission per ``run()`` (2 finish, then the third), left-padding with
    0 and a shared cache position.  Tokens equal JAX's; every logit row
    that picks a token has a top-2 gap far above the f32 tolerance."""
    jcfg, cfg, jparams, params = _model("qwen2.5-3b")
    prompts = [[5, 9, 2, 7], [11, 3], [8, 8, 1]]
    budgets = [5, 4, 3]
    j_eng = JEngine(jcfg, jparams, slots=2, max_len=32)
    eng = serve.ServingEngine(cfg, params, slots=2, max_len=32, device="cpu")
    seen = []
    decode = eng.__class__._decode

    def recording(self, tokens):
        logits = decode(self, tokens)
        seen.append(logits[:, -1].clone())
        return logits

    eng._decode = recording.__get__(eng)
    for e, R in ((j_eng, JRequest), (eng, serve.Request)):
        for p, n in zip(prompts, budgets):
            e.submit(R(list(p), max_new_tokens=n))
    for run in range(2):
        j_done, done = j_eng.run(), eng.run()
        assert len(done) == len(j_done) == (2 if run == 0 else 1)
        assert [r.out for r in done] == [r.out for r in j_done]
        assert all(r.done and len(r.out) == r.max_new_tokens for r in done)
    assert eng.cache["pos"] == int(j_eng.cache["pos"])
    for logits in seen:
        top2 = logits.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).min().item()
        assert gap > 100 * RTOL * logits.abs().max().item(), gap


def test_serve_cli_on_the_cpu(capsys):
    done = serve.main(["--arch", "h2o-danube-3-4b", "--reduced", "--device",
                       "cpu"])
    assert len(done) == serve.REQUESTS
    assert all(len(r.prompt) == serve.PROMPT_LEN
               and len(r.out) == serve.NEW_TOKENS for r in done)
    assert f"served {serve.REQUESTS} of {serve.REQUESTS} requests" in \
        capsys.readouterr().out
