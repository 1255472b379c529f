"""Yi-6B [arXiv:2403.04652]: llama-architecture GQA, RMSNorm + SwiGLU."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, head_dim=128, rope_theta=5e6,
)

REDUCED = ModelConfig(
    name="yi-6b-reduced", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, head_dim=32, rope_theta=5e6,
    dtype="float32", moe_group_size=64, attn_chunk=64,
)
