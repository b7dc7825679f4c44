"""StarCoder2-15B [arXiv:2402.19173]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152. GQA + RoPE; plain GeLU MLP and LayerNorm (starcoder2 style)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
    norm_type="layernorm",
    pos_emb="rope",
    rope_theta=100000.0,
    sliding_window=4096,  # starcoder2-15b uses 4k sliding window attention
    use_bias=True,
)
