"""Qwen2-VL-2B [arXiv:2409.12191]: text backbone with M-RoPE (3-section
multimodal rotary positions); vision frontend is a stub — the LM shapes feed
text positions to all three M-RoPE streams (exactly the text path)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    rope_type="mrope", mrope_sections=(16, 24, 24),
)

REDUCED = ModelConfig(
    name="qwen2-vl-2b-reduced", family="dense",
    num_layers=2, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=32,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    rope_type="mrope", mrope_sections=(4, 6, 6),
    dtype="float32", moe_group_size=64, attn_chunk=64,
)
