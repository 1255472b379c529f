"""Model substrate layers of the port: norms, RoPE / M-RoPE, linears,
attention (full-sequence through ``kernels.ops.attention``, one-token
decode over a cache), the gated and plain MLPs, and the embedding table.

Every function is a pure function over a params dict, as in
``repro.models.layers``, with the same names, tree keys and layouts
(weights ``(in, out)``, activations ``(B, S, d)``, heads ``(B, H, S, D)``),
so a JAX params tree converts leaf by leaf (``interop.lm_params_from_numpy``).
Initializers draw from a ``torch.Generator`` and take a leading ``stack``
shape (the layer axis of ``transformer``'s stacked params); JAX's threefry
draws differ, so parity rests on converted arrays, never on seeds.

Not ported yet, each raising where it is reached: TT-compressed linears and
embeddings (``tt_mode`` other than ``"none"``), MoE, cross-attention, and
``chunked_attention`` (ROADMAP queue A item 14).  The JAX package's
``act.constrain*`` calls are sharding hints, no-ops without a mesh, and
have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TT_TODO = ("TT-compressed LM linears and embeddings (tt_mode='all' / "
            "'embedding') are not ported yet (ROADMAP queue A item 14e)")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of ``cfg.dtype``."""
    return _DTYPES[cfg.dtype]


def _normal(generator: torch.Generator, shape: tuple, std: float,
            dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``std · N(0, 1)`` drawn in float32 on the generator's device, then
    cast and moved, as the JAX package draws in f32 and casts."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device).mul_(std)
    return w.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------- norm

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, params: dict,
               x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rmsnorm(x, params["scale"], cfg.norm_eps)


def init_norm(cfg: ModelConfig, dim: int, device: torch.device,
              stack: tuple = ()) -> dict:
    p = {"scale": torch.ones(stack + (dim,), dtype=torch.float32,
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(stack + (dim,), dtype=torch.float32,
                                device=device)
    return p


# -------------------------------------------------------------------- linear

@dataclasses.dataclass(frozen=True)
class LinearSpec:
    in_dim: int
    out_dim: int
    use_bias: bool = False
    tt: bool = False
    tt_rank: int = 16
    tt_L: int = 3


def init_linear(generator: torch.Generator, spec: LinearSpec,
                dtype: torch.dtype, device: torch.device,
                stack: tuple = ()) -> dict:
    if spec.tt:
        raise NotImplementedError(_TT_TODO)
    std = math.sqrt(2.0 / (spec.in_dim + spec.out_dim))
    p = {"w": _normal(generator, stack + (spec.in_dim, spec.out_dim), std,
                      dtype, device)}
    if spec.use_bias:
        p["b"] = torch.zeros(stack + (spec.out_dim,), dtype=dtype,
                             device=device)
    return p


def apply_linear(params: dict, x: torch.Tensor,
                 spec: LinearSpec) -> torch.Tensor:
    if spec.tt:
        raise NotImplementedError(_TT_TODO)
    y = x @ params["w"]
    if spec.use_bias:
        y = y + params["b"]
    return y


def linear_spec(cfg: ModelConfig, in_dim: int, out_dim: int,
                bias: bool = False) -> LinearSpec:
    return LinearSpec(in_dim=in_dim, out_dim=out_dim, use_bias=bias,
                      tt=(cfg.tt_mode == "all"),
                      tt_rank=cfg.tt_rank, tt_L=cfg.tt_L)


# ---------------------------------------------------------------- embeddings

def init_embedding(generator: torch.Generator, cfg: ModelConfig,
                   device: torch.device) -> dict:
    if cfg.tt_mode in ("embedding", "all"):
        raise NotImplementedError(_TT_TODO)
    return {"table": _normal(generator, (cfg.vocab_size, cfg.d_model),
                             1.0 / math.sqrt(cfg.d_model), dtype_of(cfg),
                             device)}


def embedding_lookup(params: dict, ids: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    if "table" not in params:
        raise NotImplementedError(_TT_TODO)
    return params["table"][ids]


# ----------------------------------------------------------------------- rope

def rope_freqs(cfg: ModelConfig, positions: torch.Tensor) -> tuple:
    """cos/sin tables ``(B, S, head_dim // 2)``.  positions: (B, S) for
    rope; (3, B, S) for mrope (temporal / height / width streams; the text
    path feeds the same positions to all three, which reduces M-RoPE to
    RoPE, as in qwen2-vl's text path)."""
    half = cfg.resolved_head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    inv = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                       device=positions.device), exponent)
    if cfg.rope_type == "mrope" and positions.ndim == 3:
        secs = cfg.mrope_sections or (half,)
        if sum(secs) != half:
            raise ValueError(f"mrope sections {secs} do not sum to {half}")
        parts, off = [], 0
        for si, sec in enumerate(secs):
            parts.append(positions[si][..., None].float()
                         * inv[off:off + sec])
            off += sec
        f = torch.cat(parts, dim=-1)
    else:
        pos = positions if positions.ndim == 2 else positions[0]
        f = pos[..., None].float() * inv
    return torch.cos(f), torch.sin(f)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, D) — rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[:, None].float(), sin[:, None].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------------- attention

def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: int, window: int = 0) -> torch.Tensor:
    """Single/few-query attention over a (possibly partially filled) cache,
    in plain PyTorch as in the JAX package (no kernel).  q: (B, H, Sq, D);
    k/v: (B, KH, Smax, D); ``kv_len``: the valid length."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    group = H // KH
    qg = q.reshape(B, KH, group, Sq, D).float()
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.float()) * (
        1.0 / math.sqrt(D))
    k_pos = torch.arange(Sk, device=q.device)
    mask = k_pos < kv_len
    if window:
        mask &= k_pos > kv_len - 1 - window
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    return out.reshape(B, H, Sq, D).to(q.dtype)


def attention_specs(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": linear_spec(cfg, d, cfg.num_heads * hd, bias=cfg.qkv_bias),
        "wk": linear_spec(cfg, d, cfg.num_kv_heads * hd, bias=cfg.qkv_bias),
        "wv": linear_spec(cfg, d, cfg.num_kv_heads * hd, bias=cfg.qkv_bias),
        "wo": linear_spec(cfg, cfg.num_heads * hd, d, bias=False),
    }


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   device: torch.device, stack: tuple = ()) -> dict:
    return {name: init_linear(generator, spec, dtype_of(cfg), device, stack)
            for name, spec in attention_specs(cfg).items()}


def _qkv(params: dict, cfg: ModelConfig, x: torch.Tensor,
         rope: tuple | None) -> tuple:
    """Projected, head-split and rotated q (B, H, S, hd) and k, v
    (B, KH, S, hd)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    specs = attention_specs(cfg)
    q = apply_linear(params["wq"], x, specs["wq"])
    k = apply_linear(params["wk"], x, specs["wk"])
    v = apply_linear(params["wv"], x, specs["wv"])
    q = q.reshape(B, S, cfg.num_heads, hd).transpose(1, 2)
    k = k.reshape(B, S, cfg.num_kv_heads, hd).transpose(1, 2)
    v = v.reshape(B, S, cfg.num_kv_heads, hd).transpose(1, 2)
    if rope is not None and cfg.rope_type != "none":
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    return q, k, v


def attention_fwd(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  rope: tuple | None, causal: bool = True, window: int = 0,
                  return_kv: bool = False):
    """Full-sequence attention (prefill, forward) through
    ``kernels.ops.attention``: the flash-attention kernel on the card, its
    plain version on the CPU.  ``window`` 0 is full attention.  With
    ``return_kv`` also the rotated k and v ``(B, KH, S, hd)``, which
    ``transformer.prefill`` keeps as the cache (the JAX package recomputes
    them there and lets XLA merge the duplicate projections)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x, rope)
    o = ops.attention(q, k, v, causal=causal, window=window or None)
    o = o.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.resolved_head_dim)
    out = apply_linear(params["wo"], o, attention_specs(cfg)["wo"])
    return (out, k, v) if return_kv else out


def attention_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     rope: tuple | None, window: int = 0) -> tuple:
    """Decode: write the new tokens' k, v into the cache at ``pos`` and
    attend over the prefix.  x: (B, S, d); cache_k/v: (B, KH, Smax, hd).
    The cache tensors are updated in place (the JAX package returns
    updated copies); as there, a write past the end is clamped to the last
    S slots (``dynamic_update_slice``)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x, rope)
    start = min(max(pos, 0), cache_k.shape[2] - S)
    cache_k[:, :, start:start + S] = k.to(cache_k.dtype)
    cache_v[:, :, start:start + S] = v.to(cache_v.dtype)
    o = decode_attention(q, cache_k, cache_v, kv_len=pos + S, window=window)
    o = o.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.resolved_head_dim)
    out = apply_linear(params["wo"], o, attention_specs(cfg)["wo"])
    return out, cache_k, cache_v


# ----------------------------------------------------------------------- MLP

def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.act == "silu":  # gated
        return {"w_gate": linear_spec(cfg, d, ff),
                "w_up": linear_spec(cfg, d, ff),
                "w_down": linear_spec(cfg, ff, d)}
    return {"w_up": linear_spec(cfg, d, ff, bias=True),
            "w_down": linear_spec(cfg, ff, d, bias=True)}


def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             device: torch.device, d_ff: int | None = None,
             stack: tuple = ()) -> dict:
    return {n: init_linear(generator, s, dtype_of(cfg), device, stack)
            for n, s in mlp_specs(cfg, d_ff).items()}


def mlp_fwd(params: dict, cfg: ModelConfig, x: torch.Tensor,
            d_ff: int | None = None) -> torch.Tensor:
    """SwiGLU (``act="silu"``) or GELU with JAX's default tanh
    approximation (``act="gelu"``), activations in f32."""
    specs = mlp_specs(cfg, d_ff)
    if cfg.act == "silu":
        g = apply_linear(params["w_gate"], x, specs["w_gate"])
        u = apply_linear(params["w_up"], x, specs["w_up"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        u = apply_linear(params["w_up"], x, specs["w_up"])
        h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return apply_linear(params["w_down"], h, specs["w_down"])
