"""Snowflake Arctic-480B [hf:Snowflake/snowflake-arctic-base]: 35L d_model=7168
56H (GQA kv=8) expert d_ff=4864, MoE 128e top-2 PLUS a dense residual MLP on
every layer (Arctic's dense-MoE hybrid)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    dense_d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    dense_residual=True,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_emb="rope",
    rope_theta=10000.0,
)
