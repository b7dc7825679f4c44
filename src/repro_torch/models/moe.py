"""Mixture-of-Experts layer (the port of ``repro.models.moe``): top-k
routing with the sort-based capacity dispatch, Arctic's dense residual
MLP and Kimi's shared experts.

``moe_apply`` computes the JAX package's ``_moe_sort`` (the route it
takes without an expert-parallel mesh) or, with ``impl="shard_map"``
under a policy whose ``expert`` axes hold more than one rank and divide
the experts, its ``_moe_shard_map`` (``moe_ep``): local routing per
data-parallel shard and an explicit all-to-all over the expert-parallel
group. Sort route: assignments are sorted by expert (a stable sort),
each takes a slot in its expert's capacity buffer, assignments past the
capacity are dropped, every expert's FFN runs as one batched product
over the (E, C, D) buffer, and each token sums its kept outputs weighted
by the renormalised gates. Every shape is static (the per-expert counts
are an integer ``index_add_`` into E slots, as ``jnp.bincount(length=E)``;
dropped assignments write a spare row that is cut off), so a fake-tensor
trace carries the route.

Where the JAX function scatter-adds, the port writes and sums in a
fixed order, so that two runs on the card give the same bits (CUDA's
``index_add_`` adds in whatever order its atomics land):

* the dispatch buffer receives one token per kept slot, so it is
  filled by a copy to unique rows (dropped ones to the spare row);
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
from repro_torch.sharding.constrain import (
    active_policy,
    force_replicate,
    is_dtensor,
    local_shard_map,
    logical_constraint,
)


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
    """buf[dst] = xf[src] into an (n, D) zero buffer, a `dst` of n (a
    dropped assignment) writing a spare row that is cut off; the
    backward sums each token's slot gradients in a fixed order
    (``_sum_slots`` over `slots`, each token's K buffer rows in expert
    order, ``n`` for a dropped assignment)."""

    @staticmethod
    def forward(ctx, xf, src, dst, slots, n: int):
        ctx.save_for_backward(slots)
        buf = xf.new_zeros((n + 1, xf.shape[1]))
        buf[dst] = xf[src]
        return buf[:n]

    @staticmethod
    def backward(ctx, grad_buf):
        (slots,) = ctx.saved_tensors
        return _sum_slots(grad_buf, slots), None, None, None, None


def _plan(experts: torch.Tensor, E: int, cap: int) -> dict:
    """The sort dispatch of (T, K) expert choices into E slots of `cap`:
    the stable order by expert, each assignment's expert, token and
    buffer row (``E * cap`` when dropped), whether it is kept, and each
    token's K buffer rows in expert order (``slots``, (T, K))."""
    T, K = experts.shape
    flat_e = experts.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # per-expert counts at a static shape (jnp.bincount(length=E))
    counts = torch.zeros(E, dtype=sorted_e.dtype, device=experts.device) \
        .index_add_(0, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(T * K, device=experts.device) - starts[sorted_e]
    keep = slot < cap
    token_of = order // K
    buf_idx = torch.where(keep, sorted_e * cap + slot, E * cap)
    # group by token; a stable sort keeps each token's K in expert order
    by_token = torch.argsort(token_of, stable=True)
    return {"order": order, "keep": keep, "token_of": token_of,
            "buf_idx": buf_idx, "by_token": by_token,
            "slots": buf_idx[by_token].view(T, K)}


def _dispatch(xf: torch.Tensor, plan: dict, n: int,
              dtype: torch.dtype) -> torch.Tensor:
    """The (n, D) send buffer: one token per kept slot."""
    return _Dispatch.apply(xf.to(dtype), plan["token_of"], plan["buf_idx"],
                           plan["slots"], n)


def _combine(out_flat: torch.Tensor, plan: dict, gates: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """(T, D): each token's kept expert outputs weighted by its gates,
    added in expert order from zero; dropped slots gather row 0 with
    weight 0."""
    T, K = gates.shape
    keep = plan["keep"]
    gathered = out_flat[torch.where(keep, plan["buf_idx"], 0)]
    w = (gates.reshape(T * K)[plan["order"]] * keep).to(dtype)
    contrib = (gathered * w[:, None])[plan["by_token"]] \
        .view(T, K, out_flat.shape[1])
    y = torch.zeros((T, out_flat.shape[1]), dtype=dtype,
                    device=out_flat.device)
    for j in range(K):
        y = y + contrib[:, j]
    return y


def _residual_mlps(p: dict, xf: torch.Tensor, y: torch.Tensor,
                   cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    if cfg.shared_experts:
        y = y + mlp_apply(p["shared"], xf, cfg.mlp_type, dtype)
    if cfg.dense_residual:
        y = y + mlp_apply(p["residual"], xf, cfg.mlp_type, dtype)
    return y


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              dtype: torch.dtype, impl: str = "sort") -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) (module doc). impl: 'sort' or
    'shard_map' (the expert-parallel all-to-all where the active policy
    has an eligible mesh and x is a DTensor on it, else the sort route,
    as the JAX package)."""
    if impl == "shard_map" and x.ndim == 3 and is_dtensor(x):
        act = active_policy()
        if act is not None:
            from repro_torch.sharding.rules import mesh_shape
            mesh, policy = act
            sizes = mesh_shape(mesh)
            ep_axes = tuple(a for a in policy.rules.get("expert", ())
                            if a in sizes)
            ep = 1
            for a in ep_axes:
                ep *= sizes[a]
            if ep > 1 and cfg.num_experts % ep == 0:
                return moe_ep(p, x, cfg, dtype, mesh, policy, ep_axes)
    return _moe_sort(p, x, cfg, dtype)


def _moe_sort(p: dict, x: torch.Tensor, cfg: ModelConfig,
              dtype: torch.dtype) -> torch.Tensor:
    """The sort route over every token at once. On DTensors the global
    sort, the dispatch and the combine run on every rank over all the
    tokens (``force_replicate``, counted: DTensor has no sharding rule
    for a scatter along a sharded dim), on local tensors, and the (E, C,
    D) buffer and the expert FFN are sharded ("expert", "fsdp")."""
    B, S, D = x.shape
    E = cfg.num_experts
    T = B * S
    xf = x.reshape(T, D)
    xr = force_replicate(xf, "moe_sort_dispatch")
    gates, experts = route(p, xr, cfg, dtype)
    cap = capacity(cfg, T)
    plan = None if is_dtensor(xr) else _plan(experts, E, cap)

    def dispatch(xl, el):
        return _dispatch(xl, plan or _plan(el, E, cap), E * cap, dtype)

    def combine(ol, gl, el):
        return _combine(ol.reshape(E * cap, D), plan or _plan(el, E, cap),
                        gl, dtype)

    buf = _replicated(dispatch, xr, experts)
    ebuf = logical_constraint(buf.view(E, cap, D), ("expert", "fsdp", None))
    out_buf = expert_ffn(p, ebuf, cfg.mlp_type, dtype)
    out_buf = logical_constraint(out_buf, ("expert", "fsdp", None))
    out_buf = force_replicate(out_buf, "moe_sort_combine")
    y = _replicated(combine, out_buf, gates, experts)
    return _residual_mlps(p, xf, y, cfg, dtype).reshape(B, S, D)


def _replicated(fn, *args):
    """``fn(*args)``; on replicated DTensors, `fn` runs on each rank's
    whole local copies (the result replicated too)."""
    if not is_dtensor(args[0]):
        return fn(*args)
    from repro_torch.sharding.rules import P
    return local_shard_map(fn, args[0].device_mesh, in_specs=(P(),) * len(args),
                           out_spec=P())(*args)


def moe_ep(p: dict, x: torch.Tensor, cfg: ModelConfig, dtype: torch.dtype,
           mesh, policy, ep_axes: tuple) -> torch.Tensor:
    """Expert-parallel MoE with explicit all-to-all dispatch (the JAX
    package's ``_moe_shard_map``; x and the weights DTensors on `mesh`).

    Per (data-parallel) shard: local top-k routing, one local sort into
    an (E, cap, D) send buffer, ``all_to_all_single`` over the EP group
    (split experts / concat sources), the local experts' batched FFN,
    the reverse all-to-all, the weighted combine. When EP uses a mesh
    axis that doesn't carry batch, the sequence is split across the EP
    ranks (``seq_split``) so routing isn't replicated ep-fold, and the
    output comes back sequence-sharded. The same eligibility, split
    and capacity rules as the JAX function; its capacity is not rounded
    to 128. The all-to-all is the autograd form, so the backward
    exchanges gradients the reverse way."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.sharding.rules import P, mesh_shape

    sizes = mesh_shape(mesh)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    ep_axis = ep_axes if len(ep_axes) > 1 else ep_axes[0]
    ep = 1
    for a in ep_axes:
        ep *= sizes[a]
    dp_axes = tuple(a for a in policy.rules.get("batch", ()) if a in sizes)
    dp = 1
    for a in dp_axes:
        dp *= sizes[a]
    if B % max(dp, 1):
        return _moe_sort(p, x, cfg, dtype)
    seq_split = (len(ep_axes) == 1 and ep_axes[0] not in dp_axes
                 and S % ep == 0 and (B // max(dp, 1)) * (S // ep) > 0)
    T_loc = (B // max(dp, 1)) * (S // ep if seq_split else S)
    cap = max(1, int(T_loc * K * cfg.capacity_factor / E))
    group = mesh[ep_axes]._flatten().get_group() if len(ep_axes) > 1 \
        else mesh.get_group(ep_axes[0])
    swiglu = cfg.mlp_type == "swiglu"

    def exchange(t: torch.Tensor) -> torch.Tensor:
        """(ep, ...) chunks: chunk j to EP rank j; returns the chunks
        received, by source rank."""
        return funcol.all_to_all_single_autograd(t.contiguous(), None, None,
                                                 group)

    def local(xs, router, wg, wu, wd):
        if seq_split:
            r = mesh.get_local_rank(ep_axes[0])
            n = xs.shape[1] // ep
            xs = xs[:, r * n:(r + 1) * n]
        Bl, Sl, _ = xs.shape
        T = Bl * Sl
        xf = xs.reshape(T, D)
        gates, experts = route({"router": router}, xf, cfg, dtype)
        plan = _plan(experts, E, cap)
        send = _dispatch(xf, plan, E * cap, dtype)          # (E*cap, D)
        # dispatch: experts split across EP ranks, sources concatenated
        recv = exchange(send.view(ep, E // ep, cap, D))     # (src, e, c, D)
        recv = recv.permute(1, 0, 2, 3).reshape(E // ep, ep * cap, D)
        w = {"w_up": wu, "w_down": wd}
        if swiglu:
            w["w_gate"] = wg
        h = expert_ffn(w, recv, cfg.mlp_type, dtype)
        h = h.view(E // ep, ep, cap, D).permute(1, 0, 2, 3)
        back = exchange(h).reshape(E * cap, D)              # (E*cap, D)
        return _combine(back, plan, gates, dtype).reshape(Bl, Sl, D)

    batch_spec = dp_axes if len(dp_axes) > 1 \
        else (dp_axes[0] if dp_axes else None)
    wg = p["w_gate"] if swiglu else p["w_up"]  # unused for gelu
    out_spec = P(batch_spec, ep_axis, None) if seq_split \
        else P(batch_spec, None, None)
    ew = P(ep_axis, None, None)
    y = local_shard_map(local, mesh,
                        in_specs=(P(batch_spec, None, None), P(None, None),
                                  ew, ew, ew),
                        out_spec=out_spec)(x, p["router"], wg, p["w_up"],
                                           p["w_down"])
    # the activation layout (a sequence-split result is gathered unless
    # the policy shards "seq"), so that the residual MLPs' tokens and
    # gradients keep one layout
    y = logical_constraint(y, ("batch", "seq", None))
    xf = x.reshape(-1, D)
    if cfg.shared_experts:
        y = y + mlp_apply(p["shared"], xf, cfg.mlp_type,
                          dtype).reshape(B, S, D)
    if cfg.dense_residual:
        y = y + mlp_apply(p["residual"], xf, cfg.mlp_type,
                          dtype).reshape(B, S, D)
    return y


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
