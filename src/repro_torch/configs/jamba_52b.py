"""Jamba-v0.1-52B [arXiv:2403.19887]: 32L d_model=4096 32H (GQA kv=8)
d_ff=14336, MoE 16e top-2 on every other layer, attention on 1 of every 8
layers (1:7 attn:mamba interleave). Hybrid -> runs long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    dense_d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,          # jamba places attention mid-block
    ssm_type="mamba",
    d_state=16,
    d_conv=4,
    ssm_expand=2,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_emb="none",         # jamba uses no explicit positional encoding
)
