"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407]: 40L d_model=5120
32H (GQA kv=8) d_ff=14336 vocab=131072, 128k ctx. head_dim=128 (q_dim 4096)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
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
)
