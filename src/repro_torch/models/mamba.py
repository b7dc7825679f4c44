"""Mamba (S6) selective state-space mixer (the port of
``repro.models.mamba``): the sequence path for prefill, with the final
decode state, and the one-token decode step.

The JAX package scans the sequence in checkpointed chunks; the chunks
only group steps for the backward pass, and the forward is the plain
recurrence, so the port runs one loop over steps and accepts ``chunk``
without using it. In training, autograd keeps each step's state for the
backward pass (the JAX package recomputes them chunk by chunk): the
same gradients, more memory.

Decode state: a (d_conv - 1)-row window of the conv's inputs and the
(d_inner, d_state) SSM state, float32. After a prefill of S < d_conv - 1
tokens the window is left-padded with the zeros the sequence path pads
with, so the next ``mamba_decode`` sees a full window (the JAX package
slices ``xi_raw[:, S - (d_conv - 1):]`` there, whose negative start
wraps to fewer rows, and its next decode step raises)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, (cfg.d_model + 15) // 16)


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def ssm_inputs(p: dict, x: torch.Tensor, cfg: ModelConfig,
               dtype: torch.dtype) -> tuple:
    """(dt, B, C, A) from x (B, S, Din) after the conv and SiLU: dt, B
    and C in float32, A = -exp(A_log) from the float32 ``A_log``."""
    N, R = cfg.d_state, dt_rank(cfg)
    proj = x @ p["x_proj"].to(dtype)
    dt, Bm, Cm = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].to(dtype) + p["dt_bias"].to(dtype))
    A = -torch.exp(p["A_log"].float())
    return dt.float(), Bm.float(), Cm.float(), A


def mamba_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                dtype: torch.dtype, chunk: int = 64,
                return_state: bool = False):
    """x: (B, S, D) -> (B, S, D) [, final decode state]. `chunk` is the
    JAX package's backward-pass grouping; the forward ignores it."""
    del chunk
    B, S, D = x.shape
    xz = x @ p["in_proj"].to(dtype)
    xi_raw, z = xz.chunk(2, dim=-1)                       # (B, S, Din)

    # causal depthwise conv over the sequence
    pad = F.pad(xi_raw, (0, 0, cfg.d_conv - 1, 0))
    conv_w = p["conv_w"].to(dtype)
    conv = sum(pad[:, i:i + S, :] * conv_w[i] for i in range(cfg.d_conv))
    xi = F.silu(conv + p["conv_b"].to(dtype))

    dt, Bm, Cm, A = ssm_inputs(p, xi, cfg, dtype)
    xs = xi.float()
    h = torch.zeros((B, xi.shape[-1], cfg.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * A)
        dBx = dt[:, t, :, None] * Bm[:, t, None, :] * xs[:, t, :, None]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1).to(dtype) + xi * p["D"].to(dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(dtype)
    if return_state:
        # the last d_conv - 1 rows of the zero-padded inputs
        return out, {"conv": pad[:, S:, :].to(dtype), "ssm": h}
    return out


def mamba_decode_state(cfg: ModelConfig, batch: int, dtype,
                       device=None) -> dict:
    Din = d_inner(cfg)
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, Din), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, Din, cfg.d_state),
                               dtype=torch.float32, device=device)}


def mamba_decode(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig,
                 dtype: torch.dtype) -> tuple:
    """One token. x: (B, D) -> ((B, D), new state). The new window
    holds the conv state's dtype promoted with the working dtype, as
    the JAX package's concatenation gives."""
    xz = x @ p["in_proj"].to(dtype)
    xi, z = xz.chunk(2, dim=-1)                           # (B, Din)
    wdt = torch.promote_types(state["conv"].dtype, xi.dtype)
    window = torch.cat([state["conv"].to(wdt), xi[:, None, :].to(wdt)],
                       dim=1)                             # (B, d_conv, Din)
    conv = torch.einsum("bkd,kd->bd", window.to(dtype),
                        p["conv_w"].to(dtype))
    xi = F.silu(conv + p["conv_b"].to(dtype))

    dt, Bm, Cm, A = ssm_inputs(p, xi[:, None, :], cfg, dtype)
    dt_t, B_t, C_t = dt[:, 0], Bm[:, 0], Cm[:, 0]
    dA = torch.exp(dt_t[..., None] * A)
    h = dA * state["ssm"] + dt_t[..., None] * B_t[:, None, :] \
        * xi.float()[..., None]
    y = torch.einsum("bdn,bn->bd", h, C_t).to(dtype) + xi * p["D"].to(dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(dtype), {"conv": window[:, 1:, :], "ssm": h}
