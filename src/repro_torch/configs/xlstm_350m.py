"""xLSTM-350M [arXiv:2405.04517]: 24L d_model=1024 4H, no FFN (d_ff=0),
vocab=50304. Alternating sLSTM/mLSTM blocks (xLSTM[1:1]); linear-time
recurrence -> runs the long_500k decode cell."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_type="xlstm",
    ssm_expand=2,
    d_conv=4,
    mlp_type="swiglu",
    norm_type="layernorm",
    pos_emb="none",
)
