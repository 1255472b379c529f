"""StarCoder2-7B [arXiv:2402.19173]: dense GQA transformer, learned-bias
attention, RoPE, LayerNorm + (non-gated) GELU MLP."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152, head_dim=128,
    qkv_bias=True, rope_theta=1e5, norm="layernorm", act="gelu",
)

REDUCED = ModelConfig(
    name="starcoder2-7b-reduced", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, head_dim=32,
    qkv_bias=True, rope_theta=1e5, norm="layernorm", act="gelu",
    dtype="float32", moe_group_size=64, attn_chunk=64,
)
