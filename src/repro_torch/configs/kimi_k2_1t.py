"""Kimi-K2 1T-A32B [arXiv:2501.kimi2, paper-table]: 61L d_model=7168 64H
(GQA kv=8, head_dim=112) MoE 384e top-8, expert d_ff=2048, vocab=163840.
Layer 0 dense with d_ff=18432 (= (8 routed + 1 shared) x 2048, DeepSeek-V3
lineage) and 1 shared expert on MoE layers."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    dense_d_ff=18432,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    shared_experts=1,
    first_dense_layers=1,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_emb="rope",
    rope_theta=50000.0,
)
