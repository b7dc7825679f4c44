"""AdamW over trees of torch tensors, with optional block-quantized 8-bit
moments (the port of ``repro.train.optimizer``: the same names,
defaults, state layout and arithmetic).

The optimizer state is ``{"m": tree, "v": tree, "step": int32
scalar}``. Moments are float32, bfloat16, or, with ``moments="int8"``,
per-leaf ``{"q": int8 (rows, block), "scale": float32 (rows, 1)}``:
the flattened moment in blocks of ``block`` values, each scaled by its
absmax / 127 and rounded half to even (``torch.round``, as
``jnp.round``), the rows padded with zeros to a multiple of
``_SHARD_PAD`` so that ``q`` and ``scale`` have the JAX package's shapes
(its padding lets the quantized state shard on any mesh). Updates are
functional: ``adamw_update`` returns new tensors, as the JAX function
does. ``opt_state_specs`` gives the state's logical axes (the moments
mirror the params; int8 moments shard their block rows FSDP-style).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments: str = "float32"     # float32 | bfloat16 | int8
    block: int = 256             # int8 quantization block


# ----------------------------------------------------------- int8 moments

_SHARD_PAD = 512  # block rows padded to a multiple (the JAX package's)


def _q8(x: torch.Tensor, block: int) -> dict:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    rowpad = (-blocks.shape[0]) % _SHARD_PAD
    if rowpad:
        blocks = torch.nn.functional.pad(blocks, (0, 0, 0, rowpad))
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _dq8(s: dict, shape) -> torch.Tensor:
    blocks = s["q"].float() * s["scale"]
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape)


def _encode_moment(x: torch.Tensor, cfg: OptConfig):
    if cfg.moments == "int8":
        return _q8(x, cfg.block)
    if cfg.moments == "bfloat16":
        return x.to(torch.bfloat16)
    return x


def _decode_moment(s, cfg: OptConfig, shape=None) -> torch.Tensor:
    if cfg.moments == "int8":
        return _dq8(s, shape)
    return s.float()


# ----------------------------------------------------------------- trees

def _flatten(tree, is_leaf=lambda x: False) -> list:
    """Leaves of a nested dict in sorted-key order (jax.tree's order)."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return [x for k in sorted(tree) for x in _flatten(tree[k], is_leaf)]
    return [tree]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)


def _is_q8(x) -> bool:
    return isinstance(x, dict) and "q" in x


# ----------------------------------------------------------------- adamw

def init_opt_state(params, cfg: OptConfig) -> dict:
    """Zero moments in ``cfg.moments``' encoding, step 0 (int32), on
    the params' device."""
    leaves = _flatten(params)
    dev = leaves[0].device if leaves else None

    def zeros():
        return _unflatten(params, [
            _encode_moment(torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), cfg)
            for p in leaves])
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_specs, cfg: OptConfig):
    """Moment shardings mirror the params (plus scale arrays for int8)."""
    def lift(ax):
        if cfg.moments == "int8":
            # quantized layout is flattened, nblocks padded to _SHARD_PAD:
            # shard the block rows FSDP-style
            return {"q": ("fsdp", None), "scale": ("fsdp", None)}
        return ax

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return lift(node)
    moments = walk(param_specs)
    return {"m": moments, "v": moments, "step": None}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of
    squares, the sums added in leaf order."""
    total = None
    for g in _flatten(tree):
        s = g.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(params, grads, opt_state: dict, cfg: OptConfig) -> tuple:
    """One AdamW step with global-norm clipping: (new params, new
    optimizer state, the gradients' global norm before clipping)."""
    step = opt_state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12),
                        max=1.0) if cfg.grad_clip else 1.0
    stepf = step.float()
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def upd(p, g, m_s, v_s):
        g = g.float() * scale
        m = _decode_moment(m_s, cfg, p.shape)
        v = _decode_moment(v_s, cfg, p.shape)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * p.float()
        new_p = (p.float() - cfg.lr * delta).to(p.dtype)
        return new_p, _encode_moment(m, cfg), _encode_moment(v, cfg)

    flat_p = _flatten(params)
    flat_g = _flatten(grads)
    flat_m = _flatten(opt_state["m"], _is_q8)
    flat_v = _flatten(opt_state["v"], _is_q8)
    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m,
                                                    flat_v)]
    new_params = _unflatten(params, [o[0] for o in out])
    new_m = _unflatten(params, [o[1] for o in out])
    new_v = _unflatten(params, [o[2] for o in out])
    return new_params, {"m": new_m, "v": new_v, "step": step}, gn
