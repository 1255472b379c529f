"""Whisper-base [arXiv:2212.04356]: enc-dec transformer BACKBONE only; the
conv audio frontend is a stub (input_specs supplies precomputed frame
embeddings, encoder_frames=1500)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, encoder_layers=6, encoder_frames=1500,
    d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    norm="layernorm", act="gelu", rope_type="none",
)

REDUCED = ModelConfig(
    name="whisper-base-reduced", family="encdec",
    num_layers=2, encoder_layers=2, encoder_frames=32,
    d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    norm="layernorm", act="gelu", rope_type="none",
    dtype="float32", moe_group_size=64, attn_chunk=64,
)
