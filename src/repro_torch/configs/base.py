"""``ModelConfig``: the architecture dataclass (the dense-family fields
of ``repro.configs.base``; the other families are later slices)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense (the only family the port serves)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    # --- mlp / norm / positional ---
    mlp_type: str = "swiglu"    # swiglu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0
    pos_emb: str = "rope"       # rope | none

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    use_bias: bool = False      # linear-layer biases (starcoder2 style)
    sliding_window: int = 0     # 0 = full attention

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """A small config of the same family for CPU tests (the JAX
        package's ``reduced()`` widths)."""
        base = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                    head_dim=16, d_ff=128, vocab_size=256,
                    name=self.name + "-reduced")
        base.update(overrides)
        return dataclasses.replace(self, **base)
