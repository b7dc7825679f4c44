"""Train-state and train-step factories (the port of
``repro.train.step``).

The state is the JAX package's tree, ``{"params": ..., "opt": {"m",
"v", "step"}}``, of torch tensors on the model's device: float32 master
weights in the model's parameter layout (``models.lm.param_specs``) and
the optimizer state of ``train.optimizer``; the model is any
``build_model`` result (``DecoderLM`` or ``EncDecModel``), whose layout
``param_specs`` gives by family. A step computes the loss
and every gradient (``torch.autograd.grad`` of ``model.loss``) and
applies AdamW, returning a new state, as the JAX step does. The serving
steps wrap ``prefill`` and ``decode_step``, loading the weights they are
given into the model first unless it holds them already."""
from __future__ import annotations

import torch

from repro_torch.core.layout import canonical_paths
from repro_torch.models.lm import flat_specs, init_device, param_specs
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state


def nest(flat: dict) -> dict:
    """{"a/b/c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    out: dict = {}
    for name, leaf in flat.items():
        *head, last = name.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def init_train_state(model, seed: int, opt_cfg: OptConfig) -> dict:
    """Float32 master weights drawn on the model's device from `seed`
    (``init_device``'s rules) and a zero optimizer state."""
    params = nest(init_device(model.cfg, seed, dtype="float32",
                              device=model.device))
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def train_state_template(cfg, opt_cfg: OptConfig) -> dict:
    """The state's tree of shapes and dtypes without memory (what
    ``resume`` restores into, as the JAX package's ``jax.eval_shape`` of
    ``init_train_state``): the params' specs as meta tensors and
    ``init_opt_state`` over them."""
    params = nest({n: torch.empty(sp.shape, device="meta")
                   for n, sp in flat_specs(param_specs(cfg)).items()})
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def make_train_step(model, opt_cfg: OptConfig):
    """``train_step(state, batch) -> (new state, {"loss", "grad_norm"})``
    (device scalars). On DTensors (under ``sharding.constrain.
    use_policy``) each gradient takes its parameter's layout, so the new
    state keeps the old one's."""
    def train_step(state, batch):
        named = canonical_paths(state["params"])
        leaves = [p.detach().requires_grad_() for _, p in named]
        with torch.enable_grad():
            loss = model.loss(nest({n: p for (n, _), p in zip(named, leaves)}),
                              batch)
            grads = [_like(g, p) for g, p in
                     zip(torch.autograd.grad(loss, leaves), leaves)]
        with torch.no_grad():
            new_params, new_opt, gn = adamw_update(
                state["params"],
                nest({n: g for (n, _), g in zip(named, grads)}),
                state["opt"], opt_cfg)
        metrics = {"loss": loss.detach(), "grad_norm": gn}
        return {"params": new_params, "opt": new_opt}, metrics
    return train_step


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's layout (the state keeps its
    shardings from step to step, as the JAX step's out_shardings pin
    them); a plain gradient as it is."""
    from repro_torch.sharding.constrain import is_dtensor

    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _serve(model, params):
    """Load `params` (a nested or flat tree) into `model` unless it
    serves them already: the port's model holds the weights it runs."""
    if params is not None and params is not model.params:
        model.load_flat(dict(canonical_paths(params)))


def make_prefill_step(model):
    """``prefill_step(params, batch, state) -> (logits, state)``: the
    model's ``prefill`` over `params` (the reference's signature)."""
    def prefill_step(params, batch, state):
        _serve(model, params)
        return model.prefill(batch, state)
    return prefill_step


def make_decode_step(model):
    """``decode_step(params, state, tokens, pos) -> (logits, state)``:
    the model's ``decode_step`` over `params` (the reference's
    signature)."""
    def decode_step(params, state, tokens, pos):
        _serve(model, params)
        return model.decode_step(state, tokens, pos)
    return decode_step


def cast_params(params, dtype=torch.bfloat16):
    """Serving-time weight cast (floating leaves only)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params
