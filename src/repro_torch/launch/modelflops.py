"""MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) bookkeeping (the
port of ``repro.launch.modelflops``: the same arithmetic over the port's
parameter paths).

N excludes embedding/unembedding tables (standard convention). Expert
tensors are detected structurally: leaves on a ``w_gate/w_up/w_down`` path
whose shape carries the ``num_experts`` dim; they contribute scaled by
(experts_per_token / num_experts). Decode/prefill use the 2·N forward-only
factor; enc-dec decode counts decoder-side params only.

`param_shapes` is a nested dict of leaves with a ``shape`` (the model's
``param_shapes()``: ``LeafSpec``s, or tensors)."""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeConfig

_EXPERT_NAMES = ("w_gate", "w_up", "w_down")


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield "/".join(prefix + (str(k),)), v


def param_counts(cfg: ModelConfig, param_shapes) -> dict:
    total = expert = embed = decoder = 0
    for p, leaf in _leaves(param_shapes):
        shape = tuple(leaf.shape)
        n = math.prod(shape) if shape else 1
        top = p.split("/")[0]
        if top in ("embed", "unembed"):
            embed += n
            continue
        total += n
        if cfg.num_experts and any(nm in p for nm in _EXPERT_NAMES) \
                and cfg.num_experts in shape and "shared" not in p \
                and "residual" not in p:
            expert += n
        if top in ("dec", "final_norm"):
            decoder += n
    active = total - expert
    if cfg.num_experts:
        active += expert * cfg.experts_per_token / cfg.num_experts
    return {"total": total, "expert": expert, "active": active,
            "embed": embed, "decoder": decoder,
            "total_with_embed": total + embed}


def model_flops(cfg: ModelConfig, shape: ShapeConfig, param_shapes) -> float:
    c = param_counts(cfg, param_shapes)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * c["active"] * B * S
    if shape.kind == "prefill":
        if cfg.is_encdec:
            return 2.0 * (c["total"] - c["decoder"]) * B * S
        return 2.0 * c["active"] * B * S
    # decode: one token per sequence
    n = c["decoder"] if cfg.is_encdec else c["active"]
    return 2.0 * n * B
