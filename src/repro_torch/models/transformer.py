"""Decoder-only LM of the port, dense family (``repro.models.transformer``).

Params keep the JAX package's tree: ``embed/table``, ``final_norm/scale``,
optionally ``unembed/w``, and ``layers_0/...`` with every leaf stacked on a
leading layer axis (JAX stacks per pattern position; a dense stack has one
position).  A Python loop over the layers takes the place of ``lax.scan``.

Entry points:
  * ``forward``      — full-sequence logits (through the flash-attention
                       kernel on the card),
  * ``prefill``      — last-token logits + populated KV caches (the same
                       kernel, once per layer),
  * ``decode_step``  — one token against the caches (plain attention over
                       the cache, as in the JAX package).

Only ``family="dense"`` runs; MoE, SSM, hybrid and enc-dec configs load
but raise at ``init_params`` (ROADMAP queue A items 14b–14d).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_FAMILY_TODO = {
    "moe": "MoE layers are not ported yet (ROADMAP queue A item 14b)",
    "ssm": "SSM (Mamba2) layers are not ported yet (ROADMAP queue A item "
           "14c)",
    "hybrid": "hybrid (attention + SSM + MoE) stacks are not ported yet "
              "(ROADMAP queue A item 14c)",
    "encdec": "the encoder-decoder family is not ported yet (ROADMAP queue "
              "A item 14d)",
}


def require_dense(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: " + _FAMILY_TODO.get(
                cfg.family, f"unknown family {cfg.family!r}"))


def _window(cfg: ModelConfig) -> int:
    # the JAX package asks uses_swa of the pattern position, 0 for a dense
    # stack, not of the layer index
    return cfg.sliding_window if cfg.uses_swa(0) else 0


def _layers(params: dict, cfg: ModelConfig) -> list:
    """The stacked ``layers_0`` tree as one tree of views per layer."""
    def index(tree, i):
        if isinstance(tree, dict):
            return {k: index(v, i) for k, v in tree.items()}
        return tree[i]
    return [index(params["layers_0"], i) for i in range(cfg.num_layers)]


# ---------------------------------------------------------------------- init

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> dict:
    """Random params of ``cfg`` (the JAX package's initializers, drawn from
    ``generator``; draw on the card with a CUDA generator, as a 3B model
    drawn on the host takes long) on ``device``."""
    require_dense(cfg)
    device = resolve_device(device)
    stack = (cfg.num_layers,)
    params: dict = {
        "embed": L.init_embedding(generator, cfg, device),
        "final_norm": L.init_norm(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_linear(generator, unembed_spec(cfg),
                                          L.dtype_of(cfg), device)
    layer = {"norm1": L.init_norm(cfg, cfg.d_model, device, stack),
             "attn": L.init_attention(generator, cfg, device, stack)}
    if cfg.ffn_kind(0) == "dense":
        layer["norm2"] = L.init_norm(cfg, cfg.d_model, device, stack)
        layer["mlp"] = L.init_mlp(generator, cfg, device, stack=stack)
    params["layers_0"] = layer
    return params


def unembed_spec(cfg: ModelConfig) -> L.LinearSpec:
    return L.LinearSpec(in_dim=cfg.d_model, out_dim=cfg.vocab_size,
                        tt=(cfg.tt_mode == "all"),
                        tt_rank=cfg.tt_rank, tt_L=cfg.tt_L)


# ------------------------------------------------------------------- forward

def _positions(cfg: ModelConfig, B: int, S: int,
               device: torch.device, pos: int | None = None) -> torch.Tensor:
    """(B, S) positions 0..S−1, or all ``pos`` (decode: the JAX package
    gives every token of a step the cache position); (3, B, S) for mrope."""
    if pos is None:
        pos = torch.arange(S, device=device).expand(B, S)
    else:
        pos = torch.full((B, S), pos, device=device)
    if cfg.rope_type == "mrope":
        pos = pos.expand(3, B, S)
    return pos


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    return L.rope_freqs(cfg, positions) if cfg.rope_type != "none" else None


def _mlp_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.ffn_kind(0) != "dense":
        return x
    return x + L.mlp_fwd(p["mlp"], cfg, L.apply_norm(cfg, p["norm2"], x))


def backbone(params: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """Run the layer stack on embedded inputs x: (B, S, d)."""
    require_dense(cfg)
    rope = _rope(cfg, positions)
    for p in _layers(params, cfg):
        h = L.apply_norm(cfg, p["norm1"], x)
        x = x + L.attention_fwd(p["attn"], cfg, h, rope, causal=True,
                                window=_window(cfg))
        x = _mlp_block(cfg, p, x)
    return x


def logits_fn(params: dict, cfg: ModelConfig,
              h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        if "table" not in params["embed"]:
            raise NotImplementedError(L._TT_TODO)
        return h @ params["embed"]["table"].T
    return L.apply_linear(params["unembed"], h, unembed_spec(cfg))


def forward(params: dict, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) → logits (B, S, V)."""
    require_dense(cfg)
    B, S = tokens.shape
    x = L.embedding_lookup(params["embed"], tokens, cfg)
    h = backbone(params, cfg, x, _positions(cfg, B, S, tokens.device))
    h = L.apply_norm(cfg, params["final_norm"], h)
    return logits_fn(params, cfg, h)


# -------------------------------------------------------------------- decode

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    """Zero KV caches ``k_0``/``v_0`` of shape (layers, batch, KH, max_len,
    hd) in the model's dtype, and ``pos`` 0 (a Python int)."""
    require_dense(cfg)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len,
             cfg.resolved_head_dim)
    device = resolve_device(device)
    return {"pos": 0,
            "k_0": torch.zeros(shape, dtype=L.dtype_of(cfg), device=device),
            "v_0": torch.zeros(shape, dtype=L.dtype_of(cfg), device=device)}


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor) -> tuple:
    """One decode step.  tokens: (B, S) (S = 1 when decoding) → (logits
    (B, S, V), cache with ``pos`` advanced by S).  The new K/V are written
    into the cache's tensors in place; the returned cache holds the same
    tensors."""
    require_dense(cfg)
    B, S = tokens.shape
    pos = int(cache["pos"])
    x = L.embedding_lookup(params["embed"], tokens, cfg)
    rope = _rope(cfg, _positions(cfg, B, S, tokens.device, pos))
    for i, p in enumerate(_layers(params, cfg)):
        h = L.apply_norm(cfg, p["norm1"], x)
        h, _, _ = L.attention_decode(p["attn"], cfg, h, cache["k_0"][i],
                                     cache["v_0"][i], pos, rope,
                                     window=_window(cfg))
        x = _mlp_block(cfg, p, x + h)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return (logits_fn(params, cfg, x),
            {"pos": pos + S, "k_0": cache["k_0"], "v_0": cache["v_0"]})


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int | None = None) -> tuple:
    """Full-sequence prefill: last-token logits (B, 1, V) and caches of
    ``max(max_len, S)`` slots (default S) holding the prompt's rotated
    K/V."""
    require_dense(cfg)
    B, S = tokens.shape
    max_len = max(max_len or S, S)
    x = L.embedding_lookup(params["embed"], tokens, cfg)
    rope = _rope(cfg, _positions(cfg, B, S, tokens.device))
    cache = init_cache(cfg, B, max_len, tokens.device)
    for i, p in enumerate(_layers(params, cfg)):
        h = L.apply_norm(cfg, p["norm1"], x)
        h, k, v = L.attention_fwd(p["attn"], cfg, h, rope, causal=True,
                                  window=_window(cfg), return_kv=True)
        cache["k_0"][i, :, :, :S] = k
        cache["v_0"][i, :, :, :S] = v
        x = _mlp_block(cfg, p, x + h)
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    cache["pos"] = S
    return logits_fn(params, cfg, x), cache
