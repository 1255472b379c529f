"""Jamba-1.5-Large (398B) [arXiv:2403.19887]: hybrid Mamba+attention with a
1:7 interleave (attention on layer i % 8 == 0) and MoE (16e top-2) on every
2nd layer.  SSM blocks use our Mamba2/SSD mixer (DESIGN.md notes the
mamba1->SSD substitution)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128, rope_type="none",
    num_experts=16, num_experts_per_tok=2, moe_d_ff=24576,
    attn_every=8, moe_every=2,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64, ssm_conv=4,
)

REDUCED = ModelConfig(
    name="jamba-1.5-large-reduced", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16, rope_type="none",
    num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
    attn_every=4, moe_every=2,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16, ssm_conv=4,
    dtype="float32", moe_group_size=64, attn_chunk=64, capacity_factor=8.0,
)
