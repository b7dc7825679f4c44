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
from repro_torch.sharding.constrain import (
    active_policy,
    is_dtensor,
    local_shard_map,
    logical_constraint,
    split_last,
)

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


def _heads(y: torch.Tensor, n: int, cfg: ModelConfig) -> torch.Tensor:
    """(..., n * hd) -> (..., n, hd)."""
    return split_last(y, tuple(y.shape[:-1]) + (n, cfg.head_dim), "heads")


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, dtype) -> tuple:
    """q (..., H, hd), k and v (..., Hkv, hd) of x (..., D)."""
    return (_heads(_proj(p, x, "q", dtype, cfg), cfg.num_heads, cfg),
            _heads(_proj(p, x, "k", dtype, cfg), cfg.num_kv_heads, cfg),
            _heads(_proj(p, x, "v", dtype, cfg), cfg.num_kv_heads, cfg))


def attn_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, dtype,
                cache: dict, pos: torch.Tensor) -> torch.Tensor:
    """x: (B, D); cache k/v: (B, Smax, Hkv, hd), updated in place at
    `pos` (B,)."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg, dtype)
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
    q, k, v = _qkv(p, x, cfg, dtype)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = sp_flash(q, k, v, cfg, causal=causal)
    if o is None:
        q = logical_constraint(q, ("batch", None, "heads", None))
        k = logical_constraint(k, ("batch", None, "kv_heads", None))
        o = flash_attn(q, k, v, causal=causal, window=cfg.sliding_window,
                       skip_masked_blocks=skip_blocks)
        o = logical_constraint(o, ("batch", None, "heads", None))
    return _proj(p, o.reshape(B, S, cfg.q_dim), "o", dtype, cfg), k, v


def sp_flash(q, k, v, cfg: ModelConfig, *, causal: bool):
    """Sequence-parallel attention (the JAX package's ``_sp_flash``):
    each rank of the policy's ``seq`` mesh axis attends its slice of the
    queries against the full K/V with the causal offset rank * S / n,
    the batch split over the policy's ``batch`` axes where it divides.
    The lever for archs whose head count doesn't divide the TP axis
    (arctic 56, smollm 15). None (take the plain route) unless a policy
    is active, q is a DTensor, and ``seq`` maps to exactly one mesh axis
    of size n > 1 that divides S."""
    from repro_torch.sharding.rules import P, mesh_shape

    act = active_policy()
    if act is None or not is_dtensor(q):
        return None
    mesh, policy = act
    sizes = mesh_shape(mesh)
    seq_axes = tuple(a for a in policy.rules.get("seq", ()) if a in sizes)
    if len(seq_axes) != 1:
        return None
    axis = seq_axes[0]
    n = sizes[axis]
    B, S = q.shape[0], q.shape[1]
    if n <= 1 or S % n:
        return None
    b_axes = tuple(a for a in policy.rules.get("batch", ())
                   if a in sizes and a != axis)
    bsz = 1
    for a in b_axes:
        bsz *= sizes[a]
    bspec = (b_axes if len(b_axes) > 1 else b_axes[0]) \
        if (b_axes and B % bsz == 0) else None

    def local(ql, kf, vf):
        off = mesh.get_local_rank(axis) * (S // n)
        return flash_attn(ql, kf, vf, causal=causal, q_offset=off,
                          window=cfg.sliding_window)

    return local_shard_map(
        local, mesh,
        in_specs=(P(bspec, axis, None, None), P(bspec, None, None, None),
                  P(bspec, None, None, None)),
        out_spec=P(bspec, axis, None, None))(q, k, v)


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
    q = _heads(_proj(p, x, "q", dtype, cfg), cfg.num_heads, cfg)
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
    return {"k": _heads(_proj(p, enc_out, "k", dtype, cfg),
                        cfg.num_kv_heads, cfg),
            "v": _heads(_proj(p, enc_out, "v", dtype, cfg),
                        cfg.num_kv_heads, cfg)}


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


def decode_state_specs(sd: SubDef) -> dict:
    """Logical axis specs for a sublayer's decode state."""
    if sd.mixer in ("attn", "cross_attn"):
        return {"k": ("batch", "kv_seq", "kv_heads", None),
                "v": ("batch", "kv_seq", "kv_heads", None)}
    if sd.mixer == "mamba":
        return {"conv": ("batch", None, "tp"), "ssm": ("batch", "tp", None)}
    if sd.mixer == "mlstm":
        return {"C": ("batch", "heads", None, None),
                "n": ("batch", "heads", None), "m": ("batch", "heads")}
    if sd.mixer == "slstm":
        return {"h": ("batch", "tp"), "c": ("batch", "tp"),
                "n": ("batch", "tp"), "m": ("batch", "tp"),
                "conv": ("batch", None, "tp")}
    raise ValueError(sd.mixer)


def _apply_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, sd: SubDef,
               dtype, moe_impl: str = "sort") -> torch.Tensor:
    h = apply_norm(p["norm2"], x, cfg.norm_type, cfg.norm_eps)
    if sd.ffn == "moe":
        if h.ndim == 2:
            y = moe_apply(p["ffn"], h[:, None, :], cfg, dtype,
                          impl=moe_impl)[:, 0]
        else:
            y = moe_apply(p["ffn"], h, cfg, dtype, impl=moe_impl)
    else:
        y = mlp_apply(p["ffn"], h, cfg.mlp_type, dtype)
    return x + y


def sublayer_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, sd: SubDef,
                   dtype, *, mode: str, positions=None, pos=None,
                   state=None, enc_out=None,
                   skip_blocks: bool = False, moe_impl: str = "sort") -> tuple:
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
    ``RunFlags.skip_masked_blocks`` (train mode), `moe_impl`
    ``RunFlags.moe_impl``."""
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
    x = residual(x + y)
    if sd.ffn != "none":
        x = residual(_apply_ffn(p, x, cfg, sd, dtype, moe_impl=moe_impl))
    return x, new_state


def residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream in its activation layout, ("batch", "seq",
    None) or ("batch", None) for one decode token: under a policy, a
    partial sum left by a row-parallel projection is reduced here, once
    per mixer and FFN (the JAX package leaves the placement to XLA)."""
    axes = ("batch", "seq", None) if x.ndim == 3 else ("batch", None)
    return logical_constraint(x, axes)
