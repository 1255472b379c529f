"""H2O-Danube-3-4B [arXiv:2401.16818]: llama+mistral mix with
sliding-window attention (mistral-style window on every layer)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    d_ff=10240, vocab_size=32000, head_dim=120,
    sliding_window=4096, swa_every=1, rope_theta=1e4,
)

REDUCED = ModelConfig(
    name="h2o-danube-3-4b-reduced", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, head_dim=32,
    sliding_window=64, swa_every=1, rope_theta=1e4,
    dtype="float32", moe_group_size=64, attn_chunk=64,
)
