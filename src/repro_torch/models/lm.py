"""Decoder-only LM, dense family (the port of ``repro.models.lm``).

``DecoderLM`` holds the JAX package's parameter layout: ``embed``
(padded vocab, D), an ``unembed`` when embeddings are untied, the layer
stack ``g0/s0/...`` with a leading dim R = num_layers, and
``final_norm``. ``load_flat`` takes exactly the flat ``{path: array}``
dict that ``repro.train.checkpoint.state_to_tree`` makes of a JAX
``DecoderLM``'s params — which is also what ``ImageHandle.restore_tree``
returns for an image of them — so the two packages serve the same
weights. Matrices are cast once to the working dtype at load (the JAX
package casts them at every use; the values are the same); norm scales
stay float32.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import sublayer_decode, sublayer_prefill
from repro_torch.models.common import apply_norm, embed_lookup, pad_vocab
from repro_torch.train.checkpoint import LeafSpec, tree_from_flat


@dataclass(frozen=True)
class RunFlags:
    """``dtype``: the working dtype, ``"bfloat16"`` or ``"float32"``."""
    dtype: str = "bfloat16"


def param_specs(cfg: ModelConfig) -> dict:
    """Nested {name: LeafSpec} of the dense layout, float32."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    f32 = np.dtype(np.float32)
    R, D, V = cfg.num_layers, cfg.d_model, pad_vocab(cfg.vocab_size)

    def spec(*shape):
        return LeafSpec(tuple(shape), f32)

    mixer = {"wq": spec(R, D, cfg.q_dim), "wk": spec(R, D, cfg.kv_dim),
             "wv": spec(R, D, cfg.kv_dim), "wo": spec(R, cfg.q_dim, D)}
    if cfg.use_bias:
        mixer.update(bq=spec(R, cfg.q_dim), bk=spec(R, cfg.kv_dim),
                     bv=spec(R, cfg.kv_dim), bo=spec(R, D))
    if cfg.mlp_type == "swiglu":
        ffn = {"w_gate": spec(R, D, cfg.d_ff), "w_up": spec(R, D, cfg.d_ff),
               "w_down": spec(R, cfg.d_ff, D)}
    else:
        ffn = {"w_up": spec(R, D, cfg.d_ff), "w_down": spec(R, cfg.d_ff, D)}
    norm = ({"scale": spec(R, D), "bias": spec(R, D)}
            if cfg.norm_type == "layernorm" else {"scale": spec(R, D)})
    tree = {"embed": spec(V, D),
            "g0": {"s0": {"norm1": dict(norm), "norm2": dict(norm),
                          "mixer": mixer, "ffn": ffn}},
            "final_norm": {k: spec(D) for k in norm}}
    if not cfg.tie_embeddings:
        tree["unembed"] = spec(V, D)
    return tree


def _flat_specs(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def init_flat(cfg: ModelConfig, seed: int) -> dict:
    """Random float32 weights {path: numpy} from `seed`, with the JAX
    package's init scales (normal / sqrt(fan_in), embeddings 0.02, norm
    scales 1, biases 0)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, sp in sorted(_flat_specs(param_specs(cfg)).items()):
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("scale",):
            out[name] = np.ones(sp.shape, np.float32)
        elif leaf.startswith("b"):
            out[name] = np.zeros(sp.shape, np.float32)
        else:
            scale = 0.02 if name in ("embed", "unembed") \
                else 1.0 / np.sqrt(sp.shape[-2])
            w = rng.standard_normal(sp.shape, dtype=np.float32)
            w *= np.float32(scale)
            out[name] = w
    return out


class DecoderLM(nn.Module):
    def __init__(self, cfg: ModelConfig, flags: RunFlags = RunFlags(),
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.flags = flags
        self.device = resolve_device(device)
        self.dtype = getattr(torch, flags.dtype)
        self.specs = param_specs(cfg)
        self.params: dict | None = None
        self._layers: list = []

    @torch.no_grad()
    def load_flat(self, flat: dict) -> "DecoderLM":
        """Load {path: array}: exactly this config's names and shapes
        (raises on a missing, extra or misshapen tensor)."""
        want = _flat_specs(self.specs)
        missing, extra = set(want) - set(flat), set(flat) - set(want)
        if missing or extra:
            raise KeyError(f"load_flat: missing {sorted(missing)}, "
                           f"unexpected {sorted(extra)}")
        for name, sp in want.items():
            if tuple(np.shape(flat[name])) != sp.shape:
                raise ValueError(f"load_flat: {name} has shape "
                                 f"{np.shape(flat[name])}, want {sp.shape}")
        tree = tree_from_flat(self.specs, flat)

        def place(node, path):
            if isinstance(node, dict):
                return {k: place(v, path + (k,)) for k, v in node.items()}
            t = torch.from_numpy(np.require(node, requirements="CW"))
            keep_f32 = path[-1] in ("scale", "bias")
            return t.to(self.device, torch.float32 if keep_f32
                        else self.dtype)

        self.params = place(tree, ())
        g = self.params["g0"]["s0"]
        self._layers = [
            {sub: {k: v[layer] for k, v in g[sub].items()} for sub in g}
            for layer in range(self.cfg.num_layers)]
        return self

    def init_decode_state(self, batch: int, max_len: int,
                          dtype=torch.bfloat16) -> dict:
        """KV caches, (R, B, max_len, Hkv, hd) each; bfloat16 by
        default, whatever the working dtype, as in the JAX package."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"g0": {"s0": {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device)}}}

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg, p = self.cfg, self.params
        x = apply_norm(p["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        table = p["embed"] if cfg.tie_embeddings else p["unembed"]
        return x @ table.to(self.dtype).T

    def _check_loaded(self):
        if self.params is None:
            raise RuntimeError("DecoderLM has no weights: call load_flat")

    @torch.no_grad()
    def prefill(self, batch: dict, state: dict) -> tuple:
        """Full-sequence forward over ``batch["tokens"]`` (B, S) at
        positions 0..S-1 that fills the decode state: returns
        (last-position logits (B, padded vocab) in the working dtype,
        state), the KV caches holding rows [0, S) (updated in place).
        ``decode_step`` continues at position S."""
        self._check_loaded()
        cfg, dtype = self.cfg, self.dtype
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        x = embed_lookup(self.params["embed"], tokens, dtype)   # (B, S, D)
        positions = torch.arange(tokens.shape[1], device=self.device)
        cache = state["g0"]["s0"]
        for layer, pl in enumerate(self._layers):
            x = sublayer_prefill(pl, x, cfg, dtype,
                                 {"k": cache["k"][layer],
                                  "v": cache["v"][layer]}, positions)
        return self._logits(x[:, -1]), state

    @torch.no_grad()
    def decode_step(self, state: dict, tokens: torch.Tensor,
                    pos: torch.Tensor) -> tuple:
        """tokens: (B,) ids; pos: (B,) positions being written. Returns
        (logits (B, padded vocab) in the working dtype, state); the KV
        caches in `state` are updated in place."""
        self._check_loaded()
        cfg, dtype, p = self.cfg, self.dtype, self.params
        tokens = tokens.to(self.device)
        pos = pos.to(self.device)
        x = embed_lookup(p["embed"], tokens, dtype)          # (B, D)
        cache = state["g0"]["s0"]
        for layer, pl in enumerate(self._layers):
            x = sublayer_decode(pl, x, cfg, dtype,
                                {"k": cache["k"][layer],
                                 "v": cache["v"][layer]}, pos)
        return self._logits(x), state
