"""Whisper-base [arXiv:2212.04356]: enc-dec, 6L encoder + 6L decoder,
d_model=512 8H d_ff=2048 vocab=51865. The conv audio frontend is a stub:
the model takes precomputed frame embeddings (B, frames, d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,            # decoder layers
    encoder_layers=6,
    is_encdec=True,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,          # whisper uses MHA (kv == heads)
    d_ff=2048,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    pos_emb="sinusoidal",
    frontend="audio_stub",
    use_bias=True,
)
