"""GQA decode attention against a KV cache (the port of the decode half
of ``repro.models.attention``; flash attention for prefill is a later
slice — the engine prefills by decoding)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, lengths: torch.Tensor, *,
                window: int = 0) -> torch.Tensor:
    """One-token attention. q: (B, Hq, hd); caches (B, Smax, Hkv, hd);
    lengths (B,) valid lengths (the new token, already in the cache,
    sits at lengths-1). Scores, softmax and the weighted sum in
    float32; the result is cast to q.dtype."""
    B, Smax, Hkv, hd = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) \
        * (1.0 / math.sqrt(hd))
    pos = torch.arange(Smax, device=q.device)[None, :]
    mask = pos < lengths[:, None]
    if window:
        mask &= pos >= (lengths[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, hd).to(q.dtype)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    lengths: torch.Tensor) -> None:
    """Write one new (k, v) per sequence at its current length, IN
    PLACE (the JAX package returns new caches; updating in place keeps
    one cache in device memory). k_new/v_new: (B, Hkv, hd)."""
    b_idx = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[b_idx, lengths] = k_new.to(k_cache.dtype)
    v_cache[b_idx, lengths] = v_new.to(v_cache.dtype)
