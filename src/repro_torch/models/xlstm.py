"""xLSTM blocks [arXiv:2405.04517] (the port of ``repro.models.xlstm``):
mLSTM (matrix memory, pre-up-projection) and sLSTM (scalar memory with
a true recurrence, post-up-projection), each with its sequence path
(prefill, train) and its one-token decode step.

Exponential gating is stabilised with the running max (the ``m``
state) in float32, as in the JAX package. The JAX package scans the
sequence in checkpointed chunks (``mamba._scan_chunked``); the chunks
only group steps for its backward pass, so the port runs one loop over
the steps in order and accepts ``chunk`` without using it: the result
does not depend on it. In training, autograd keeps each step's state
(the same gradients, more memory), as ``models.mamba`` does.

Parameters are the JAX package's: mLSTM ``{up, wq, wk, wv, w_if, b_if,
down, norm_scale}``, sLSTM ``{conv_w, w_x, r, b, ff_up, ff_down}``.
``b_if``, ``r`` and ``b`` are read in float32 (no cast to the working
dtype); every other leaf is cast to it at use.

Decode state: mLSTM ``C`` (B, H, hd, hd), ``n`` (B, H, hd), ``m`` (B,
H), all float32; sLSTM ``h``, ``c``, ``n``, ``m`` (B, D) float32 and a
(d_conv - 1)-row window of the conv's inputs. After a prefill of S <
d_conv - 1 tokens the window is left-padded with the zeros the
sequence path pads with, so the next ``slstm_decode`` sees a full
window (the JAX package slices ``x[:, S - (d_conv - 1):]``, whose
negative start wraps to fewer rows, and its next decode step raises),
as ``models.mamba`` does for its window."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mlp import gelu


def m_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def slstm_ff(cfg: ModelConfig) -> int:
    """The sLSTM FFN width: ``d_ff``, or 4D/3 rounded up to 128."""
    D = cfg.d_model
    return cfg.d_ff if cfg.d_ff else ((4 * D // 3 + 127) // 128) * 128


# --------------------------------------------------------------------- mLSTM

def _mlstm_qkvif(p: dict, xi: torch.Tensor, H: int, dtype) -> tuple:
    Din = xi.shape[-1]
    hd = Din // H
    lead = xi.shape[:-1]
    q = (xi @ p["wq"].to(dtype)).reshape(lead + (H, hd))
    k = (xi @ p["wk"].to(dtype)).reshape(lead + (H, hd)) \
        / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype)
    v = (xi @ p["wv"].to(dtype)).reshape(lead + (H, hd))
    gif = (xi @ p["w_if"].to(dtype)).float() + p["b_if"]
    i_pre, f_pre = gif.chunk(2, dim=-1)                   # (..., H)
    return q, k, v, i_pre, f_pre


def _mlstm_step(carry: tuple, inp: tuple) -> tuple:
    """One step. carry (C (B,H,dk,dv), n (B,H,dk), m (B,H)); inp q, k,
    v (B,H,hd), i_pre, f_pre (B,H). The denominator takes the carry's
    OLD m, as the JAX step does."""
    C, n, m = carry
    q, k, v, i_pre, f_pre = inp
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf + m - m_new)
    kf, vf = k.float(), v.float()
    C = f_g[..., None, None] * C \
        + i_g[..., None, None] * kf[..., :, None] * vf[..., None, :]
    n = f_g[..., None] * n + i_g[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs(),
                        torch.exp(-m))
    return (C, n, m_new), num / den[..., None]


def _mlstm_out(p: dict, ys: torch.Tensor, z: torch.Tensor,
               dtype) -> torch.Tensor:
    """Per-head RMS norm of the cell outputs ys (..., H, hd), the scale,
    the SiLU gate z and the down projection."""
    ms = ys.square().mean(dim=-1, keepdim=True)
    h = (ys * torch.rsqrt(ms + 1e-6)).reshape(z.shape).to(dtype)
    h = h * p["norm_scale"].to(dtype)
    h = h * F.silu(z)
    return h @ p["down"].to(dtype)


def mlstm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, dtype,
                chunk: int = 256, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D) [, final decode state]. `chunk` is the
    JAX package's backward-pass grouping; the loop ignores it."""
    del chunk
    B, S, _ = x.shape
    H, Din = cfg.num_heads, m_inner(cfg)
    hd = Din // H
    up = x @ p["up"].to(dtype)
    xi, z = up.chunk(2, dim=-1)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(p, xi, H, dtype)  # (B, S, H, hd)
    carry = (torch.zeros((B, H, hd, hd), device=x.device),
             torch.zeros((B, H, hd), device=x.device),
             torch.zeros((B, H), device=x.device))
    ys = []
    for t in range(S):
        carry, y = _mlstm_step(carry, (q[:, t], k[:, t], v[:, t],
                                       i_pre[:, t], f_pre[:, t]))
        ys.append(y)
    out = _mlstm_out(p, torch.stack(ys, dim=1), z, dtype)
    if return_state:
        C, n, m = carry
        return out, {"C": C, "n": n, "m": m}
    return out


def mlstm_decode_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    H, Din = cfg.num_heads, m_inner(cfg)
    hd = Din // H
    return {"C": torch.zeros((batch, H, hd, hd), device=device),
            "n": torch.zeros((batch, H, hd), device=device),
            "m": torch.zeros((batch, H), device=device)}


def mlstm_decode(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig,
                 dtype) -> tuple:
    """One token. x: (B, D) -> ((B, D), new state)."""
    up = x @ p["up"].to(dtype)
    xi, z = up.chunk(2, dim=-1)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(p, xi, cfg.num_heads, dtype)
    (C, n, m), y = _mlstm_step((state["C"], state["n"], state["m"]),
                               (q, k, v, i_pre, f_pre))
    return _mlstm_out(p, y, z, dtype), {"C": C, "n": n, "m": m}


# --------------------------------------------------------------------- sLSTM

def _slstm_step_fn(p: dict, H: int):
    r, b = p["r"], p["b"]

    def step(carry: tuple, x_t: torch.Tensor) -> tuple:
        h, c, n, m = carry                                 # (B, D) float32
        B, D = h.shape
        hd = D // H
        rec = torch.einsum("bhk,ghkl->gbhl", h.reshape(B, H, hd),
                           r).reshape(4, B, D)
        pre = x_t.movedim(1, 0) + rec + b.reshape(4, 1, D)  # (4, B, D)
        i_pre, f_pre, z_pre, o_pre = pre.unbind(0)
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(logf + m - m_new)
        c = f_g * c + i_g * torch.tanh(z_pre)
        n = f_g * n + i_g
        h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
        return (h, c, n, m_new), h
    return step


def _slstm_ff(p: dict, h: torch.Tensor, dtype) -> torch.Tensor:
    """The block's FFN on the cell output; the mixer returns it alone
    (the sublayer's residual adds it to the input)."""
    return gelu(h @ p["ff_up"].to(dtype)) @ p["ff_down"].to(dtype)


def slstm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, dtype,
                chunk: int = 256, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D) [, final decode state]; `chunk` as in
    ``mlstm_apply``."""
    del chunk
    B, S, D = x.shape
    pad = F.pad(x, (0, 0, cfg.d_conv - 1, 0))
    conv_w = p["conv_w"].to(dtype)
    conv = sum(pad[:, i:i + S, :] * conv_w[i] for i in range(cfg.d_conv))
    xg = F.silu(conv)
    x4 = (xg @ p["w_x"].to(dtype)).float().reshape(B, S, 4, D)
    zeros = torch.zeros((B, D), device=x.device)
    carry = (zeros, zeros, zeros, zeros)
    step = _slstm_step_fn(p, cfg.num_heads)
    hs = []
    for t in range(S):
        carry, h = step(carry, x4[:, t])
        hs.append(h)
    ff = _slstm_ff(p, torch.stack(hs, dim=1).to(dtype), dtype)
    if return_state:
        hf, cf, nf, mf = carry
        # the last d_conv - 1 rows of the zero-padded inputs
        return ff, {"h": hf, "c": cf, "n": nf, "m": mf,
                    "conv": pad[:, S:, :].to(dtype)}
    return ff


def slstm_decode_state(cfg: ModelConfig, batch: int, dtype,
                       device=None) -> dict:
    D = cfg.d_model
    out = {k: torch.zeros((batch, D), device=device)
           for k in ("h", "c", "n", "m")}
    out["conv"] = torch.zeros((batch, cfg.d_conv - 1, D), dtype=dtype,
                              device=device)
    return out


def slstm_decode(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig,
                 dtype) -> tuple:
    """One token. x: (B, D) -> ((B, D), new state). The new window holds
    the conv state's dtype promoted with x's, as the JAX package's
    concatenation gives."""
    B, D = x.shape
    wdt = torch.promote_types(state["conv"].dtype, x.dtype)
    window = torch.cat([state["conv"].to(wdt), x[:, None, :].to(wdt)],
                       dim=1)                              # (B, d_conv, D)
    conv = torch.einsum("bkd,kd->bd", window.to(dtype),
                        p["conv_w"].to(dtype))
    xg = F.silu(conv)
    x4 = (xg @ p["w_x"].to(dtype)).float().reshape(B, 4, D)
    step = _slstm_step_fn(p, cfg.num_heads)
    (h, c, n, m), _ = step((state["h"], state["c"], state["n"],
                            state["m"]), x4)
    ff = _slstm_ff(p, h.to(dtype), dtype)
    return ff, {"h": h, "c": c, "n": n, "m": m, "conv": window[:, 1:, :]}
