"""Mamba2-780m [arXiv:2405.21060]: attention-free SSD (state-space duality).
Blocks are norm + SSD mixer only (no MLP, d_ff=0).  TT compression applies
to in/out projections (DESIGN.md §4)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, rope_type="none", tie_embeddings=True,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64, ssm_conv=4,
)

REDUCED = ModelConfig(
    name="mamba2-780m-reduced", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=256, rope_type="none", tie_embeddings=True,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16, ssm_conv=4,
    dtype="float32", moe_group_size=64, attn_chunk=64,
)
