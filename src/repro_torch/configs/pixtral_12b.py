"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]: mistral-nemo-style backbone
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. The pixtral-ViT
frontend is a stub: the model takes precomputed patch embeddings
(B, num_patches, d_model) prefixed to the text sequence."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_emb="rope",
    rope_theta=1_000_000.0,
    frontend="vision_stub",
    num_patches=256,
)
