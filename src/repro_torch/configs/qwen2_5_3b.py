"""Qwen2.5-3B [hf:Qwen/Qwen2.5-*]: dense GQA, QKV bias, tied embeddings,
RMSNorm + SwiGLU, RoPE theta 1e6."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen2.5-3b-reduced", family="dense",
    num_layers=2, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=24,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    dtype="float32", moe_group_size=64, attn_chunk=64,
)
