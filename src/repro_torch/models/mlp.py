"""Feed-forward blocks (the port of ``repro.models.mlp``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(p: dict, x: torch.Tensor, kind: str,
              dtype: torch.dtype) -> torch.Tensor:
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or GeLU (``w_up``,
    ``w_down``); weights (in, out), cast to `dtype`. GeLU is ``gelu``."""
    if kind == "swiglu":
        g = x @ p["w_gate"].to(dtype)
        u = x @ p["w_up"].to(dtype)
        h = F.silu(g) * u
    else:
        h = gelu(x @ p["w_up"].to(dtype))
    return h @ p["w_down"].to(dtype)
