"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 60 routed experts top-4
(fine-grained, moe_ff=1408) + 4 shared experts (5632 = 4x1408), QKV bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=5632, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
    num_experts=60, num_experts_per_tok=4,
    num_shared_experts=4, moe_d_ff=1408, shared_d_ff=5632,
)

REDUCED = ModelConfig(
    name="qwen2-moe-a2.7b-reduced", family="moe",
    num_layers=2, d_model=96, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=24,
    qkv_bias=True, rope_theta=1e6,
    num_experts=8, num_experts_per_tok=2,
    num_shared_experts=2, moe_d_ff=64, shared_d_ff=128,
    dtype="float32", moe_group_size=64, attn_chunk=64, capacity_factor=8.0,
)
