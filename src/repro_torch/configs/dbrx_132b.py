"""DBRX-132B [hf:databricks/dbrx-base]: 16 experts top-4 fine-grained MoE,
GQA kv=8."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352, head_dim=128, rope_theta=5e5,
    num_experts=16, num_experts_per_tok=4, moe_d_ff=10752,
)

REDUCED = ModelConfig(
    name="dbrx-132b-reduced", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, head_dim=32, rope_theta=5e5,
    num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
    dtype="float32", moe_group_size=64, attn_chunk=64, capacity_factor=8.0,
)
