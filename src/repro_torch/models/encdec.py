"""Whisper-style encoder-decoder (the port of ``repro.models.encdec``).

The audio frontend is a stub, as in the JAX package: inputs are
precomputed frame embeddings (B, S, d_model). The encoder is
bidirectional attention blocks; the decoder is self-attention (cached),
cross-attention and an FFN. ``prefill`` runs the encoder and builds the
decoder's cross k/v; ``decode_step`` is the cached decoder step.

``EncDecModel`` holds the JAX package's parameter layout: ``embed`` and
``unembed`` (padded vocab, D), ``enc/s0/...`` with a leading dim
``encoder_layers``, ``dec/s0/...`` (self-attention) and ``dec/s1/...``
(cross-attention and FFN) with a leading dim ``num_layers``,
``enc_norm`` and ``final_norm``. ``load_flat`` takes the flat dict of a
JAX ``EncDecModel``'s params (``state_to_tree``, or an image's
``restore_tree``); dtypes follow ``models.lm``'s rules.

Decode state: ``{"s0": {k, v}, "s1": {k, v}}``, each (L, B, rows, Hkv,
hd): the self-attention caches (``max_len`` rows, updated in place) and
the cross k/v (``enc_len`` rows, ``encoder_seq`` by default: zeros
until a ``prefill`` replaces them with the encoder's, in the working
dtype). The serving engine never prefills, so it decodes against the
zero cross k/v, as the JAX engine does."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import (
    SubDef,
    cross_kv,
    decode_state_specs,
    sublayer_apply,
    sublayer_decode_state,
)
from repro_torch.models.common import (
    apply_norm,
    embed_lookup,
    pad_vocab,
    sin_pos,
    softmax_xent,
)
from repro_torch.models.lm import (
    RunFlags,
    _index,
    _unstack,
    input_logical_specs,
    input_specs,
    lift,
    load_tree,
    norm_axes,
    norm_specs,
    remat,
    sublayer_axes,
    sublayer_specs,
)
from repro_torch.sharding.constrain import logical_constraint
from repro_torch.train.checkpoint import LeafSpec

ENC_SUB = SubDef("attn", "dense", causal=False)
DEC_SUBS = [SubDef("attn", "none"), SubDef("cross_attn", "dense")]


def param_specs(cfg: ModelConfig) -> dict:
    """Nested {name: LeafSpec} of the JAX ``EncDecModel``'s layout,
    float32: the SHAPES (the logical axes are the method
    ``EncDecModel.param_specs()``)."""
    f32 = np.dtype(np.float32)
    V = pad_vocab(cfg.vocab_size)
    return {
        "embed": LeafSpec((V, cfg.d_model), f32),
        "unembed": LeafSpec((V, cfg.d_model), f32),
        "enc": {"s0": sublayer_specs(cfg, cfg.encoder_layers, ENC_SUB)},
        "dec": {f"s{j}": sublayer_specs(cfg, cfg.num_layers, sd)
                for j, sd in enumerate(DEC_SUBS)},
        "enc_norm": norm_specs(cfg),
        "final_norm": norm_specs(cfg),
    }


class EncDecModel(nn.Module):
    def __init__(self, cfg: ModelConfig, flags: RunFlags = RunFlags(),
                 device="cuda"):
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        self.flags = flags
        self.device = resolve_device(device)
        self.dtype = getattr(torch, flags.dtype)
        self.specs = param_specs(cfg)
        self.params: dict | None = None
        self._dec: list = []         # per decoder layer: its params

    def param_shapes(self) -> dict:
        """The nested {name: LeafSpec} (shape, float32) of this config's
        parameters."""
        return self.specs

    def param_specs(self) -> dict:
        """The LOGICAL AXES of the parameters (the JAX
        ``EncDecModel.param_specs()``), in ``param_shapes()``' layout."""
        cfg = self.cfg
        return {"embed": ("vocab", "fsdp"), "unembed": ("vocab", "fsdp"),
                "enc": {"s0": lift(sublayer_axes(cfg, ENC_SUB))},
                "dec": {f"s{j}": lift(sublayer_axes(cfg, sd))
                        for j, sd in enumerate(DEC_SUBS)},
                "enc_norm": norm_axes(cfg), "final_norm": norm_axes(cfg)}

    def decode_state_spec_tree(self) -> dict:
        """The logical axes of ``init_decode_state``'s tree."""
        return {f"s{j}": lift(decode_state_specs(sd))
                for j, sd in enumerate(DEC_SUBS)}

    def input_specs(self, shape) -> dict:
        """{name: TensorSpec} of every model input of this cell (no
        memory), as the JAX ``input_specs``."""
        return input_specs(self.cfg, shape)

    def input_logical_specs(self, shape) -> dict:
        return input_logical_specs(self.cfg, shape)

    def load_flat(self, flat: dict) -> "EncDecModel":
        """Load {path: numpy array or tensor}: exactly this config's
        names and shapes (``models.lm.load_tree``)."""
        self.params = load_tree(self.specs, flat, self.device, self.dtype)
        self._dec = [_index(self.params["dec"], r)
                     for r in range(self.cfg.num_layers)]
        return self

    def _check_loaded(self):
        if self.params is None:
            raise RuntimeError("EncDecModel has no weights: call load_flat")

    # ------------------------------------------------------------ encoder
    def encode(self, params: dict, frames) -> torch.Tensor:
        """The encoder over `frames` (B, S, D) with sinusoidal positions,
        non-causal, then ``enc_norm``: (B, S, D) in the working dtype.
        In training each layer runs under the ``remat`` policy."""
        cfg, dtype = self.cfg, self.dtype
        frames = torch.as_tensor(frames).to(self.device)
        S = frames.shape[1]
        positions = torch.arange(S, device=self.device)
        x = frames.to(dtype) + sin_pos(positions, cfg.d_model).to(dtype)
        x = logical_constraint(x, ("batch", "seq", None))
        for pl in _unstack(params["enc"], cfg.encoder_layers):
            def run(h, pl=pl):
                return sublayer_apply(pl["s0"], h, cfg, ENC_SUB, dtype,
                                      mode="encode", positions=positions)[0]
            x = remat(self.flags, run, x)
        return apply_norm(params["enc_norm"], x, cfg.norm_type, cfg.norm_eps)

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return x @ params["unembed"].to(self.dtype).T

    # -------------------------------------------------------------- train
    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy of the decoder over
        ``batch["tokens"]`` against ``batch["labels"]`` (both (B, S)),
        attending to the encoder's output of ``batch["frames"]``; a
        float32 scalar, as the JAX ``EncDecModel.loss``. `params` as
        ``DecoderLM.loss`` takes them."""
        cfg, dtype = self.cfg, self.dtype
        enc_out = self.encode(params, batch["frames"])
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        labels = torch.as_tensor(batch["labels"]).to(self.device)
        positions = torch.arange(tokens.shape[1], device=self.device)
        x = embed_lookup(params["embed"], tokens, dtype)
        x = x + sin_pos(positions, cfg.d_model).to(dtype)
        for pl in _unstack(params["dec"], cfg.num_layers):
            def run(h, pl=pl):
                h, _ = sublayer_apply(pl["s0"], h, cfg, DEC_SUBS[0], dtype,
                                      mode="train", positions=positions)
                h, _ = sublayer_apply(pl["s1"], h, cfg, DEC_SUBS[1], dtype,
                                      mode="train", enc_out=enc_out)
                return h
            x = remat(self.flags, run, x)
        x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        return softmax_xent(self._logits(params, x), labels, cfg.vocab_size)

    # -------------------------------------------------------------- serve
    def init_decode_state(self, batch: int, max_len: int,
                          dtype=torch.bfloat16, enc_len: int = 0) -> dict:
        """{s0: self-attention caches, s1: cross k/v} (module doc), in
        `dtype`; `enc_len` 0 means ``encoder_seq``."""
        cfg = self.cfg
        enc_len = enc_len or cfg.encoder_seq
        L = cfg.num_layers
        out = {}
        for j, sd in enumerate(DEC_SUBS):
            single = sublayer_decode_state(cfg, sd, batch, max_len, dtype,
                                           self.device, enc_len=enc_len)
            out[f"s{j}"] = {k: torch.zeros((L,) + tuple(v.shape),
                                           dtype=v.dtype, device=v.device)
                            for k, v in single.items()}
        return out

    @torch.no_grad()
    def prefill(self, batch: dict, state: dict) -> tuple:
        """The encoder over ``batch["frames"]`` and every decoder
        layer's cross k/v of its output. Returns (the mean-pooled
        encoder output times ``unembed``, with no norm: (B, padded
        vocab) in the working dtype, the state whose ``s1`` holds the
        new cross k/v (L, B, S, Hkv, hd) in the working dtype)."""
        self._check_loaded()
        cfg, dtype = self.cfg, self.dtype
        enc_out = self.encode(self.params, batch["frames"])
        kvs = [cross_kv(pl["s1"]["mixer"], enc_out, cfg, dtype)
               for pl in self._dec]
        state["s1"] = {k: torch.stack([kv[k] for kv in kvs])
                       for k in ("k", "v")}
        return self._logits(self.params, enc_out.mean(dim=1)), state

    @torch.no_grad()
    def decode_step(self, state: dict, tokens: torch.Tensor,
                    pos: torch.Tensor) -> tuple:
        """tokens: (B,) ids; pos: (B,) positions being written. Returns
        (logits (B, padded vocab) in the working dtype, state); the
        self-attention caches are updated in place."""
        self._check_loaded()
        cfg, dtype = self.cfg, self.dtype
        tokens = tokens.to(self.device)
        pos = pos.to(self.device)
        x = embed_lookup(self.params["embed"], tokens, dtype)
        x = x + sin_pos(pos, cfg.d_model).to(dtype)
        for r, pl in enumerate(self._dec):
            for j, sd in enumerate(DEC_SUBS):
                view = {k: v[r] for k, v in state[f"s{j}"].items()}
                x, _ = sublayer_apply(pl[f"s{j}"], x, cfg, sd, dtype,
                                      mode="decode", pos=pos, state=view)
        x = apply_norm(self.params["final_norm"], x, cfg.norm_type,
                       cfg.norm_eps)
        return self._logits(self.params, x), state
