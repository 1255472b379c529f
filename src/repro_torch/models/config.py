"""Unified model configuration for all assigned architectures — the port's
own copy of ``repro.models.config.ModelConfig``, field for field and
property for property the same (``tests/test_torch_lm.py`` checks).

One frozen dataclass covers dense/GQA transformers, MoE, SSM (Mamba2),
hybrid (Jamba) and enc-dec (Whisper) — each ``repro_torch/configs/<id>.py``
instantiates it with the published hyperparameters and a REDUCED smoke
variant.  ``tt_mode``/``tt_rank`` carry the paper's TT compression of the
linears and the embedding; the port runs ``tt_mode="none"`` only so far.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int              # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 → d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_type: str = "rope"     # rope | mrope | none
    mrope_sections: tuple = ()  # e.g. (16, 24, 24) summing to head_dim//2
    sliding_window: int = 0     # 0 = full attention
    swa_every: int = 1          # apply SWA on layers where (i % swa_every)!=0
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0           # per-expert hidden (0 → d_ff)
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 2048  # tokens per dispatch group
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1
    # --- hybrid (Jamba) ---
    attn_every: int = 0         # attention on layers where i % attn_every == 0
    moe_every: int = 0          # MoE on layers where i % moe_every == 1
    # --- enc-dec (Whisper) ---
    encoder_layers: int = 0
    encoder_frames: int = 1500  # stub audio frontend output length
    # --- misc ---
    act: str = "silu"           # silu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 1024      # KV block for chunked (flash-style) attention
    # --- paper technique: TT compression ---
    tt_mode: str = "none"       # none | embedding | all
    tt_rank: int = 16
    tt_L: int = 3

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def layer_kind(self, i: int) -> str:
        """Mixer kind for layer i: 'attn' or 'ssm'."""
        if self.family == "hybrid":
            return "attn" if (self.attn_every and i % self.attn_every == 0) else "ssm"
        if self.family == "ssm":
            return "ssm"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'moe', 'dense', or 'none' (pure-SSM blocks have no FFN)."""
        if self.family == "moe":
            return "moe"
        if self.family == "hybrid" and self.moe_every:
            return "moe" if i % self.moe_every == 1 else "dense"
        if self.d_ff == 0:
            return "none"
        return "dense"

    def uses_swa(self, i: int) -> bool:
        return bool(self.sliding_window) and (i % self.swa_every != 0
                                              if self.swa_every > 1 else True)

    def param_count_estimate(self) -> int:
        """Rough dense-equivalent parameter count (reported in dry-run)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        ffn_mats = 3 if self.act == "silu" else 2  # gated vs plain MLP
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        for i in range(L):
            if self.layer_kind(i) == "attn":
                total += d * hd * (self.num_heads + 2 * self.num_kv_heads)
                total += self.num_heads * hd * d
            else:
                di = self.d_inner
                h = self.ssm_heads
                total += d * (2 * di + 2 * self.ssm_groups * self.ssm_state + h)
                total += di * d + di  # out proj + conv-ish
            if self.ffn_kind(i) == "moe":
                total += self.num_experts * 3 * d * self.expert_d_ff
                total += self.num_shared_experts * 3 * d * (self.shared_d_ff or self.expert_d_ff)
                total += d * self.num_experts
            elif self.ffn_kind(i) == "dense":
                total += ffn_mats * d * self.d_ff
        if self.family == "encdec":
            for _ in range(self.encoder_layers):
                total += 4 * d * d + 3 * d * self.d_ff   # enc self-attn + ffn
                total += 4 * d * d                        # dec cross-attn
        return total

    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.num_experts == 0:
            return self.param_count_estimate()
        d = self.d_model
        full = self.param_count_estimate()
        moe_layers = sum(1 for i in range(self.num_layers)
                         if self.ffn_kind(i) == "moe")
        inactive = moe_layers * (self.num_experts - self.num_experts_per_tok) \
            * 3 * d * self.expert_d_ff
        return full - inactive
