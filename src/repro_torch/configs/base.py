"""``ModelConfig``: the architecture dataclass (the fields of
``repro.configs.base``), the JAX package's ``ShapeConfig`` cells
(``SHAPES``) and ``applicable_shapes``."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1          # MoE on layers where (layer % moe_every == moe_offset)
    moe_offset: int = 0
    dense_residual: bool = False   # arctic: dense MLP residual alongside MoE
    shared_experts: int = 0        # kimi/deepseek-style always-on experts
    first_dense_layers: int = 0    # kimi: leading dense layers
    dense_d_ff: int = 0            # d_ff used by dense layers in a MoE model
    capacity_factor: float = 1.25

    # --- hybrid (jamba) ---
    attn_period: int = 0        # attention every `attn_period` layers (0 = all attn)
    attn_offset: int = 0        # which slot in the period is attention

    # --- ssm ---
    ssm_type: str = ""          # "mamba" | "xlstm"
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2

    # --- mlp / norm / positional ---
    mlp_type: str = "swiglu"    # swiglu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0
    pos_emb: str = "rope"       # rope | sinusoidal | learned | none

    # --- enc-dec (whisper) ---
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500     # default whisper 30s

    # --- modality frontend stubs ---
    frontend: str = ""          # "" | audio_stub | vision_stub
    num_patches: int = 256      # vision_stub: patch tokens prefixed to text

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    use_bias: bool = False      # linear-layer biases (starcoder2/whisper style)
    sliding_window: int = 0     # 0 = full attention

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.dense_d_ff == 0:
            object.__setattr__(self, "dense_d_ff", self.d_ff)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_subquadratic(self) -> bool:
        """Whether the arch can decode at 500k context (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self, **overrides) -> "ModelConfig":
        """A small config of the same family for CPU tests (the JAX
        package's ``reduced()`` rules)."""
        base = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            d_ff=128,
            dense_d_ff=128 if self.num_experts else 0,
            vocab_size=256,
            encoder_layers=2 if self.is_encdec else 0,
            num_experts=4 if self.num_experts else 0,
            experts_per_token=min(2, self.experts_per_token)
            if self.num_experts else 0,
            shared_experts=min(1, self.shared_experts),
            first_dense_layers=min(1, self.first_dense_layers),
            attn_period=min(2, self.attn_period) if self.attn_period else 0,
            attn_offset=0,
            num_patches=8,
            d_state=8,
            ssm_expand=2,
            name=self.name + "-reduced",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable_shapes(cfg: ModelConfig) -> list[ShapeConfig]:
    """The shape cells that lower for this arch: ``long_500k`` only for
    the sub-quadratic (SSM and hybrid) families."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.is_subquadratic:
        out.append(LONG_500K)
    return out
