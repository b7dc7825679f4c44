"""Dense sublayer = (norm -> attention -> residual) + (norm -> MLP ->
residual), in prefill and decode mode (the port of the dense part of
``repro.models.blocks``). Parameters are the JAX package's layout:
``norm1``/``norm2`` ``{scale}`` (and ``bias`` for layernorm), ``mixer``
``{wq, wk, wv, wo}`` with (in, out) matrices (and ``bq``...``bo`` with
``use_bias``), ``ffn`` ``{w_gate, w_up, w_down}`` or ``{w_up,
w_down}``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    decode_attn,
    flash_attn,
    update_kv_cache,
)
from repro_torch.models.common import apply_norm, apply_rope
from repro_torch.models.mlp import mlp_apply


def _proj(p: dict, x: torch.Tensor, nm: str, dtype, cfg: ModelConfig):
    y = x @ p[f"w{nm}"].to(dtype)
    if cfg.use_bias:
        y = y + p[f"b{nm}"].to(dtype)
    return y


def attn_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, dtype,
                cache: dict, pos: torch.Tensor) -> torch.Tensor:
    """x: (B, D); cache k/v: (B, Smax, Hkv, hd), updated in place at
    `pos` (B,)."""
    B = x.shape[0]
    q = _proj(p, x, "q", dtype, cfg).reshape(B, cfg.num_heads, cfg.head_dim)
    k = _proj(p, x, "k", dtype, cfg).reshape(B, cfg.num_kv_heads,
                                             cfg.head_dim)
    v = _proj(p, x, "v", dtype, cfg).reshape(B, cfg.num_kv_heads,
                                             cfg.head_dim)
    if cfg.pos_emb == "rope":
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    update_kv_cache(cache["k"], cache["v"], k, v, pos)
    o = decode_attn(q, cache["k"], cache["v"], pos + 1,
                    window=cfg.sliding_window)
    return _proj(p, o.reshape(B, cfg.q_dim), "o", dtype, cfg)


def sublayer_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, dtype,
                    cache: dict, pos: torch.Tensor) -> torch.Tensor:
    h = apply_norm(p["norm1"], x, cfg.norm_type, cfg.norm_eps)
    x = x + attn_decode(p["mixer"], h, cfg, dtype, cache, pos)
    h = apply_norm(p["norm2"], x, cfg.norm_type, cfg.norm_eps)
    return x + mlp_apply(p["ffn"], h, cfg.mlp_type, dtype)


def attn_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, dtype,
                 cache: dict, positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) at `positions` (S,). Causal (and sliding-window)
    attention over the whole sequence; the cache k/v (B, Smax, Hkv, hd)
    are overwritten IN PLACE with rows [0, S) and zeros after, as the
    JAX package's new cache holds."""
    B, S, _ = x.shape
    q = _proj(p, x, "q", dtype, cfg).reshape(B, S, cfg.num_heads,
                                             cfg.head_dim)
    k = _proj(p, x, "k", dtype, cfg).reshape(B, S, cfg.num_kv_heads,
                                             cfg.head_dim)
    v = _proj(p, x, "v", dtype, cfg).reshape(B, S, cfg.num_kv_heads,
                                             cfg.head_dim)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attn(q, k, v, causal=True, window=cfg.sliding_window)
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        c.zero_()
        c[:, :S] = new.to(c.dtype)
    return _proj(p, o.reshape(B, S, cfg.q_dim), "o", dtype, cfg)


def sublayer_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, dtype,
                     cache: dict, positions: torch.Tensor) -> torch.Tensor:
    h = apply_norm(p["norm1"], x, cfg.norm_type, cfg.norm_eps)
    x = x + attn_prefill(p["mixer"], h, cfg, dtype, cache, positions)
    h = apply_norm(p["norm2"], x, cfg.norm_type, cfg.norm_eps)
    return x + mlp_apply(p["ffn"], h, cfg.mlp_type, dtype)
