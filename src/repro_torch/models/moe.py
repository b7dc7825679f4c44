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

The dispatch is differentiable, and its backward pass keeps the fixed
order: a token's gradient is the sum of its K slots' gradients, added
in ascending expert order from zero (``_Dispatch``), where autograd
through the copy would scatter-add them with atomics on the card. The
combine's backward writes each kept slot's gradient to its own row.
Routing indices carry no gradient; the gates do, as in the JAX package.

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


def _sum_slots(rows: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """(T, D): for each token the sum of ``rows[slots[t, j]]`` over j in
    order, from zero; slot index ``len(rows)`` reads a zero row."""
    ext = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    y = rows.new_zeros((slots.shape[0], rows.shape[1]))
    for j in range(slots.shape[1]):
        y = y + ext[slots[:, j]]
    return y


class _Dispatch(torch.autograd.Function):
    """buf[dst] = xf[src] into an (n, D) zero buffer; the backward sums
    each token's slot gradients in a fixed order (``_sum_slots`` over
    `slots`, each token's K buffer rows in expert order, ``n`` for a
    dropped assignment)."""

    @staticmethod
    def forward(ctx, xf, src, dst, slots, n: int):
        ctx.save_for_backward(slots)
        buf = xf.new_zeros((n, xf.shape[1]))
        buf[dst] = xf[src]
        return buf

    @staticmethod
    def backward(ctx, grad_buf):
        (slots,) = ctx.saved_tensors
        return _sum_slots(grad_buf, slots), None, None, None, None


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

    # group by token; a stable sort keeps each token's K in expert order
    by_token = torch.argsort(token_of, stable=True)

    # dispatch: one token per kept slot
    slots = torch.where(keep, buf_idx, E * cap)[by_token].view(T, K)
    buf = _Dispatch.apply(xf.to(dtype), token_of[keep], buf_idx[keep],
                          slots, E * cap)
    out_flat = expert_ffn(p, buf.view(E, cap, D), cfg.mlp_type,
                          dtype).reshape(E * cap, D)

    # combine: dropped slots gather row 0 with weight 0
    gathered = out_flat[torch.where(keep, buf_idx, 0)]
    w = (gates.reshape(T * K)[order] * keep).to(dtype)
    contrib = (gathered * w[:, None])[by_token].view(T, K, D)
    y = torch.zeros((T, D), dtype=dtype, device=x.device)
    for j in range(K):
        y = y + contrib[:, j]

    if cfg.shared_experts:
        y = y + mlp_apply(p["shared"], xf, cfg.mlp_type, dtype)
    if cfg.dense_residual:
        y = y + mlp_apply(p["residual"], xf, cfg.mlp_type, dtype)
    return y.reshape(B, S, D)


def aux_load_balance_loss(logits: torch.Tensor, experts: torch.Tensor,
                          num_experts: int, k: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean over tokens):
    E * sum_e(mean router probability of e * share of the K assignments
    that went to e)."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=0)                                          # (E,)
    ce = F.one_hot(experts.long(), num_experts).float().sum(dim=1) \
        .mean(dim=0) / k
    return num_experts * (me * ce).sum()
