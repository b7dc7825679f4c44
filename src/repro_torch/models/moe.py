"""Mixture-of-Experts layer (the port of ``repro.models.moe``): top-k
routing with the sort-based capacity dispatch, Arctic's dense residual
MLP and Kimi's shared experts.

``moe_apply`` computes the JAX package's ``_moe_sort``, the route it
takes on one device (its ``shard_map`` route needs an expert-parallel
mesh, which the port does not have yet). Assignments are sorted by
expert (a stable sort), each takes a slot in its expert's capacity
buffer, assignments past the capacity are dropped, every expert's FFN
runs as one batched product over the (E, C, D) buffer, and each token
sums its kept outputs weighted by the renormalised gates.

Where the JAX function scatter-adds, the port writes and sums in a
fixed order, so that two runs on the card give the same bits (CUDA's
``index_add_`` adds in whatever order its atomics land):

* the dispatch buffer receives one token per kept slot, so it is
  filled by a copy to unique rows;
* the combine gathers each token's K weighted outputs and adds them in
  ascending expert order, starting from zero: the order in which the
  JAX scatter visits them (its updates come sorted by expert).

``top_k`` breaks ties by the lower index first, as ``jax.lax.top_k``
does (``torch.topk`` does not promise an order among ties)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mlp import mlp_apply


def top_k(x: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the `k` largest entries of the last dim,
    largest first, ties to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for `tokens` routed tokens: T * K * cf / E,
    at least 1 and at most T, rounded up to a multiple of 128 from 128
    on (the JAX package's rule)."""
    cap = max(1, int(tokens * cfg.experts_per_token * cfg.capacity_factor
                     / cfg.num_experts))
    cap = min(cap, tokens)
    if cap >= 128:
        cap = ((cap + 127) // 128) * 128
    return cap


def expert_ffn(p: dict, x: torch.Tensor, kind: str,
               dtype: torch.dtype) -> torch.Tensor:
    """x: (E, C, D) -> (E, C, D), each expert's FFN over its own slots;
    expert stacks ``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F, D)."""
    if kind == "swiglu":
        g = torch.bmm(x, p["w_gate"].to(dtype))
        u = torch.bmm(x, p["w_up"].to(dtype))
        h = F.silu(g) * u
    else:
        h = F.gelu(torch.bmm(x, p["w_up"].to(dtype)), approximate="tanh")
    return torch.bmm(h, p["w_down"].to(dtype))


def route(p: dict, xf: torch.Tensor, cfg: ModelConfig,
          dtype: torch.dtype) -> tuple:
    """(gates, experts), each (T, K): the router's softmax in float32,
    its top k, the gates renormalised to sum to 1."""
    logits = (xf @ p["router"].to(dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k(probs, cfg.experts_per_token)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              dtype: torch.dtype) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) (module doc)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xf = x.reshape(T, D)
    gates, experts = route(p, xf, cfg, dtype)
    cap = capacity(cfg, T)

    flat_e = experts.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(sorted_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(T * K, device=x.device) - starts[sorted_e]
    keep = slot < cap
    token_of = order // K
    buf_idx = sorted_e * cap + slot

    # dispatch: one token per kept slot
    buf = torch.zeros((E * cap, D), dtype=dtype, device=x.device)
    buf[buf_idx[keep]] = xf[token_of[keep]].to(dtype)
    out_flat = expert_ffn(p, buf.view(E, cap, D), cfg.mlp_type,
                          dtype).reshape(E * cap, D)

    # combine: dropped slots gather row 0 with weight 0
    gathered = out_flat[torch.where(keep, buf_idx, 0)]
    w = (gates.reshape(T * K)[order] * keep).to(dtype)
    # group by token; a stable sort keeps each token's K in expert order
    by_token = torch.argsort(token_of, stable=True)
    contrib = (gathered * w[:, None])[by_token].view(T, K, D)
    y = torch.zeros((T, D), dtype=dtype, device=x.device)
    for j in range(K):
        y = y + contrib[:, j]

    if cfg.shared_experts:
        y = y + mlp_apply(p["shared"], xf, cfg.mlp_type, dtype)
    if cfg.dense_residual:
        y = y + mlp_apply(p["residual"], xf, cfg.mlp_type, dtype)
    return y.reshape(B, S, D)
