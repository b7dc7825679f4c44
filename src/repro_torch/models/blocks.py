"""Sublayer = (norm -> mixer -> residual) [+ (norm -> ffn -> residual)]
in train, encode, prefill and decode mode (the port of
``repro.models.blocks``).

A ``SubDef`` names the mixer (``attn``, ``cross_attn``, ``mamba``,
``mlstm`` or ``slstm``), the FFN (``dense``, ``moe`` or ``none``), a
``d_ff`` that overrides ``cfg.d_ff`` for a dense FFN, and whether
attention is causal. Parameters are the JAX package's layout:
``norm1``/``norm2`` ``{scale}`` (and ``bias`` for layernorm); an
attention or cross-attention ``mixer`` ``{wq, wk, wv, wo}`` with (in,
out) matrices (and ``bq``...``bo`` with ``use_bias``); a Mamba ``mixer``
``{in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias, A_log, D,
out_proj}``; the xLSTM mixers of ``models.xlstm``; a dense ``ffn``
``{w_gate, w_up, w_down}`` or ``{w_up, w_down}``; a MoE ``ffn``
``{router, w_gate, w_up, w_down}`` with (E, in, out) expert stacks, and
``shared``/``residual`` MLPs."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import (
    decode_attn,
    flash_attn,
    update_kv_cache,
)
from repro_torch.models.common import apply_norm, apply_rope
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.moe import moe_apply

# the recurrent mixers: (sequence path, one-token decode step)
RECURRENT = {"mamba": (mamba_mod.mamba_apply, mamba_mod.mamba_decode),
             "mlstm": (xlstm_mod.mlstm_apply, xlstm_mod.mlstm_decode),
             "slstm": (xlstm_mod.slstm_apply, xlstm_mod.slstm_decode)}


class SubDef(NamedTuple):
    mixer: str          # attn | cross_attn | mamba | mlstm | slstm
    ffn: str            # dense | moe | none
    d_ff: int = 0       # 0 -> cfg.d_ff
    causal: bool = True


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


def attn_seq(p: dict, x: torch.Tensor, cfg: ModelConfig, dtype,
             positions: torch.Tensor, causal: bool = True,
             skip_blocks: bool = False) -> tuple:
    """x: (B, S, D) at `positions` (S,). Attention over the whole
    sequence (causal and sliding-window as configured): (out, k, v)."""
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
    o = flash_attn(q, k, v, causal=causal, window=cfg.sliding_window,
                   skip_masked_blocks=skip_blocks)
    return _proj(p, o.reshape(B, S, cfg.q_dim), "o", dtype, cfg), k, v


def attn_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, dtype,
                 cache: dict, positions: torch.Tensor,
                 causal: bool = True) -> torch.Tensor:
    """``attn_seq``'s output; the cache k/v (B, Smax, Hkv, hd) are
    overwritten IN PLACE with rows [0, S) and zeros after, as the JAX
    package's new cache holds."""
    out, k, v = attn_seq(p, x, cfg, dtype, positions, causal)
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        c.zero_()
        c[:, :x.shape[1]] = new.to(c.dtype)
    return out


def cross_attn(p: dict, x: torch.Tensor, cfg: ModelConfig, dtype,
               enc_kv: dict) -> torch.Tensor:
    """Decoder cross-attention against `enc_kv` k/v (B, Senc, Hkv, hd).
    x (B, S, D): non-causal ``flash_attn`` of S queries against the
    Senc keys; x (B, D), one decode token: ``decode_attn`` with length
    Senc for every row."""
    lead = x.shape[:-1]
    q = _proj(p, x, "q", dtype, cfg).reshape(lead + (cfg.num_heads,
                                                     cfg.head_dim))
    if x.ndim == 2:
        lengths = torch.full((x.shape[0],), enc_kv["k"].shape[1],
                             dtype=torch.int64, device=x.device)
        o = decode_attn(q, enc_kv["k"], enc_kv["v"], lengths)
    else:
        o = flash_attn(q, enc_kv["k"], enc_kv["v"], causal=False)
    return _proj(p, o.reshape(lead + (cfg.q_dim,)), "o", dtype, cfg)


def cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig,
             dtype) -> dict:
    """The cross-attention keys and values of the encoder output
    (B, Senc, D): {k, v} (B, Senc, Hkv, hd) in the working dtype."""
    lead = enc_out.shape[:-1]
    shape = lead + (cfg.num_kv_heads, cfg.head_dim)
    return {"k": _proj(p, enc_out, "k", dtype, cfg).reshape(shape),
            "v": _proj(p, enc_out, "v", dtype, cfg).reshape(shape)}


def sublayer_decode_state(cfg: ModelConfig, sd: SubDef, batch: int,
                          max_len: int, dtype, device=None,
                          enc_len: int = 0) -> dict:
    """One layer's decode state: the KV cache (`enc_len` rows for
    cross-attention), the Mamba window and SSM state, or an xLSTM
    cell's state (``models.xlstm``)."""
    if sd.mixer in ("attn", "cross_attn"):
        rows = max_len if sd.mixer == "attn" else enc_len
        shape = (batch, rows, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if sd.mixer == "mamba":
        return mamba_mod.mamba_decode_state(cfg, batch, dtype, device)
    if sd.mixer == "mlstm":
        return xlstm_mod.mlstm_decode_state(cfg, batch, device)
    if sd.mixer == "slstm":
        return xlstm_mod.slstm_decode_state(cfg, batch, dtype, device)
    raise ValueError(sd.mixer)


def _apply_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, sd: SubDef,
               dtype) -> torch.Tensor:
    h = apply_norm(p["norm2"], x, cfg.norm_type, cfg.norm_eps)
    if sd.ffn == "moe":
        if h.ndim == 2:
            y = moe_apply(p["ffn"], h[:, None, :], cfg, dtype)[:, 0]
        else:
            y = moe_apply(p["ffn"], h, cfg, dtype)
    else:
        y = mlp_apply(p["ffn"], h, cfg.mlp_type, dtype)
    return x + y


def sublayer_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, sd: SubDef,
                   dtype, *, mode: str, positions=None, pos=None,
                   state=None, enc_out=None,
                   skip_blocks: bool = False) -> tuple:
    """Returns (x, new_state). mode ``train``: x (B, S, D) at
    `positions`, stateless (new_state None), differentiable;
    ``encode``: the same with non-causal attention; ``prefill``: the
    same forward, the state filled from the sequence; ``decode``: x (B,
    D), one token at `pos` (B,). `enc_out` (B, Senc, D) feeds
    cross-attention in train and prefill mode; in decode mode it
    attends to the cross k/v in `state`. An attention cache is updated
    in place (new_state is `state`); a Mamba or xLSTM state comes back
    as new tensors, as the JAX package returns it, and so does the
    cross k/v built by a prefill. `skip_blocks` is
    ``RunFlags.skip_masked_blocks`` (train mode)."""
    if mode not in ("train", "encode", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    h = apply_norm(p["norm1"], x, cfg.norm_type, cfg.norm_eps)
    new_state = state
    if sd.mixer == "attn":
        if mode == "decode":
            y = attn_decode(p["mixer"], h, cfg, dtype, state, pos)
        elif mode == "prefill":
            y = attn_prefill(p["mixer"], h, cfg, dtype, state, positions,
                             causal=sd.causal)
        else:
            y = attn_seq(p["mixer"], h, cfg, dtype, positions,
                         causal=mode != "encode" and sd.causal,
                         skip_blocks=skip_blocks)[0]
    elif sd.mixer == "cross_attn":
        if mode == "decode":
            kv = state
        else:
            kv = cross_kv(p["mixer"], enc_out, cfg, dtype)
            if mode == "prefill":
                new_state = kv
        y = cross_attn(p["mixer"], h, cfg, dtype, kv)
    elif sd.mixer in RECURRENT:
        apply, decode = RECURRENT[sd.mixer]
        if mode == "decode":
            y, new_state = decode(p["mixer"], h, state, cfg, dtype)
        elif mode == "prefill":
            y, new_state = apply(p["mixer"], h, cfg, dtype,
                                 return_state=True)
        else:
            y = apply(p["mixer"], h, cfg, dtype)
    else:
        raise ValueError(sd.mixer)
    x = x + y
    if sd.ffn != "none":
        x = _apply_ffn(p, x, cfg, sd, dtype)
    return x, new_state
