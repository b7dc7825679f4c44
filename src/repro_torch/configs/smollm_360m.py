"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M]: 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152. Llama-arch small (head_dim=64)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_emb="rope",
    rope_theta=10000.0,
    tie_embeddings=True,
)
