"""Decoder-only LM of every family but the encoder-decoder one (the
port of ``repro.models.lm``).

``layout(cfg)`` groups the layers as the JAX package does: a dense, VLM
or MoE model is one-sublayer groups (Kimi's leading dense layers
``g0``, then its MoE layers ``g1``), xLSTM ``num_layers // 2`` pairs of
an mLSTM and an sLSTM sublayer, Jamba one group of ``attn_period``
sublayers (attention at ``attn_offset``, Mamba elsewhere, MoE where
``i % moe_every == moe_offset``). ``DecoderLM`` holds the JAX package's
parameter layout: ``embed`` (padded vocab, D), an ``unembed`` when
embeddings are untied, ``g{i}/s{j}/...`` with a leading dim R (the
group's repeats), and ``final_norm``. ``load_flat`` takes exactly the
flat ``{path: array}`` dict that ``repro.train.checkpoint.state_to_tree``
makes of a JAX ``DecoderLM``'s params, which is also what
``ImageHandle.restore_tree`` returns for an image of them, so the two
packages serve the same weights. ``param_specs``, ``init_flat`` and
``init_device`` also cover the encoder-decoder layout
(``models.encdec``).

VLM. ``batch["patches"]`` (B, num_patches, D), precomputed patch
embeddings, is prefixed to the embedded tokens; positions run over
patches and text alike, the loss drops the patch rows after the final
norm, and decoding after a prefill continues at position P + T.

Dtypes. Leaves are cast once to the working dtype at load (the JAX
package casts them at every use with ``astype(dtype)``; the values are
the same), except the leaves it reads without that cast, which stay
float32: norm ``scale``/``bias`` (norms run in float32), Mamba's
``A_log`` (``A = -exp(A_log)`` in float32), the sLSTM recurrence ``r``
and bias ``b`` and the mLSTM gate bias ``b_if`` (added to float32 gate
pre-activations). Mamba's ``D``, ``dt_bias`` and ``conv_b``, the MoE
``router`` and the xLSTM ``norm_scale`` are all read through
``astype(dtype)``, so they take the working dtype.

Training. ``loss(params, batch)`` runs every layer in train mode over
a nested params tree of this layout (float32 master weights that
require grad, cast to the working dtype at each use, as the JAX package
does), each layer under the ``RunFlags.remat`` policy, and returns the
float32 mean cross-entropy; ``load_flat``, ``prefill`` and
``decode_step`` hold weights of their own and take no gradients.

Decode state. KV caches and the Mamba and sLSTM conv windows are made
in the ``init_decode_state`` dtype (bfloat16 by default, whatever the
working dtype), SSM and xLSTM cell states in float32. Caches and states
are updated in place. A conv window takes the dtype the JAX package's
state would have: the working dtype after a prefill, and its dtype
promoted with the working dtype after a decode step (so a bfloat16
window becomes float32 at the first step of a float32 model); the state
dict then holds the converted tensor."""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import (
    SubDef,
    decode_state_specs,
    sublayer_apply,
    sublayer_decode_state,
)
from repro_torch.models.common import (
    apply_norm,
    chunked_softmax_xent,
    embed_lookup,
    pad_vocab,
    softmax_xent,
)
from repro_torch.models.mamba import d_inner, dt_rank
from repro_torch.models.xlstm import m_inner, slstm_ff
from repro_torch.sharding.constrain import (
    active_policy,
    logical_constraint,
    use_policy,
)
from repro_torch.train.checkpoint import LeafSpec

# leaves kept in float32 whatever the working dtype (module doc)
F32_LEAVES = ("scale", "bias", "A_log", "r", "b", "b_if")
# conv windows whose dtype follows the JAX package's state (module doc)
WINDOWED = ("mamba", "slstm")


@dataclass(frozen=True)
class RunFlags:
    """The JAX package's knobs. ``dtype``: the working dtype,
    ``"bfloat16"`` or ``"float32"``. The rest shape training
    (``DecoderLM.loss``) and compute the same function whatever their
    values: ``remat`` recomputes each layer's activations in the
    backward pass (``full``: all of them, ``dots``: all but the matmul
    outputs, ``none``: keeps everything); ``skip_masked_blocks`` skips
    the causally dead key blocks of the CPU's blocked attention;
    ``chunked_loss`` (0 or a sequence chunk) computes the loss without
    the full logits; ``flash_vjp`` is accepted and takes the one
    attention backward the port has (``models.attention``'s doc).
    ``moe_impl="shard_map"`` takes the expert-parallel all-to-all
    (``models.moe.moe_ep``) where the active sharding policy has an
    eligible mesh, else the sort route, as the JAX package does."""
    dtype: str = "bfloat16"
    remat: str = "full"              # full | dots | none
    skip_masked_blocks: bool = False
    chunked_loss: int = 0            # 0 = dense logits; else seq-chunk size
    flash_vjp: bool = False
    moe_impl: str = "sort"           # sort | shard_map (EP all-to-all)

    def __post_init__(self):
        if self.remat not in ("full", "dots", "none"):
            raise ValueError(f"remat {self.remat!r}: full | dots | none")
        if self.moe_impl not in ("sort", "shard_map"):
            raise ValueError(f"moe_impl {self.moe_impl!r}: sort | shard_map")


def layout(cfg: ModelConfig) -> list:
    """[(repeats, [SubDef per sublayer])] per group, as the JAX
    package's ``layout``."""
    if cfg.family in ("dense", "vlm"):
        return [(cfg.num_layers, [SubDef("attn", "dense")])]
    if cfg.family == "moe":
        groups = []
        if cfg.first_dense_layers:
            groups.append((cfg.first_dense_layers,
                           [SubDef("attn", "dense", cfg.dense_d_ff)]))
        groups.append((cfg.num_layers - cfg.first_dense_layers,
                       [SubDef("attn", "moe")]))
        return groups
    if cfg.family == "ssm" and cfg.ssm_type == "xlstm":
        return [(cfg.num_layers // 2, [SubDef("mlstm", "none"),
                                       SubDef("slstm", "none")])]
    if cfg.family == "hybrid":
        subs = []
        for i in range(cfg.attn_period):
            mixer = "attn" if i == cfg.attn_offset else "mamba"
            ffn = "moe" if (cfg.num_experts
                            and i % cfg.moe_every == cfg.moe_offset) \
                else "dense"
            subs.append(SubDef(mixer, ffn,
                               cfg.dense_d_ff if ffn == "dense" else 0))
        return [(cfg.num_layers // cfg.attn_period, subs)]
    raise ValueError(f"no layout for family {cfg.family}")


def _norm_leaves(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    norm = {"scale": ((D,), (None,))}
    if cfg.norm_type == "layernorm":
        norm["bias"] = ((D,), (None,))
    return norm


def sublayer_leaves(cfg: ModelConfig, sd: SubDef) -> dict:
    """{name: (shape, logical axes)} of one sublayer `sd` (no leading
    repeats dim): the JAX ``sublayer_init``'s shapes, and the axes it
    returns beside them (a tuple of names and Nones per leaf)."""
    D = cfg.d_model
    norm = _norm_leaves(cfg)

    def mlp(d_ff):
        out = {"w_up": ((D, d_ff), ("fsdp", "tp")),
               "w_down": ((d_ff, D), ("tp", "fsdp"))}
        if cfg.mlp_type == "swiglu":
            out["w_gate"] = ((D, d_ff), ("fsdp", "tp"))
        return out

    def attn():
        q, kv = cfg.q_dim, cfg.kv_dim
        out = {"wq": ((D, q), ("fsdp", "heads")),
               "wk": ((D, kv), ("fsdp", "kv_heads")),
               "wv": ((D, kv), ("fsdp", "kv_heads")),
               "wo": ((q, D), ("heads", "fsdp"))}
        if cfg.use_bias:
            out.update({"bq": ((q,), (None,)), "bk": ((kv,), (None,)),
                        "bv": ((kv,), (None,)), "bo": ((D,), (None,))})
        return out

    def mamba():
        Din, N, dtr = d_inner(cfg), cfg.d_state, dt_rank(cfg)
        return {"in_proj": ((D, 2 * Din), ("fsdp", "tp")),
                "conv_w": ((cfg.d_conv, Din), (None, "tp")),
                "conv_b": ((Din,), ("tp",)),
                "x_proj": ((Din, dtr + 2 * N), ("tp", None)),
                "dt_proj": ((dtr, Din), (None, "tp")),
                "dt_bias": ((Din,), ("tp",)),
                "A_log": ((Din, N), ("tp", None)), "D": ((Din,), ("tp",)),
                "out_proj": ((Din, D), ("tp", "fsdp"))}

    def mlstm():
        Din, H = m_inner(cfg), cfg.num_heads
        return {"up": ((D, 2 * Din), ("fsdp", "tp")),
                "wq": ((Din, Din), ("tp", "heads")),
                "wk": ((Din, Din), ("tp", "heads")),
                "wv": ((Din, Din), ("tp", "heads")),
                "w_if": ((Din, 2 * H), ("tp", None)),
                "b_if": ((2 * H,), (None,)),
                "down": ((Din, D), ("tp", "fsdp")),
                "norm_scale": ((Din,), ("tp",))}

    def slstm():
        H, ff = cfg.num_heads, slstm_ff(cfg)
        return {"conv_w": ((cfg.d_conv, D), (None, "tp")),
                "w_x": ((D, 4 * D), ("fsdp", "tp")),
                "r": ((4, H, D // H, D // H), (None, "heads", None, None)),
                "b": ((4 * D,), (None,)),
                "ff_up": ((D, ff), ("fsdp", "tp")),
                "ff_down": ((ff, D), ("tp", "fsdp"))}

    def moe():
        E, F = cfg.num_experts, cfg.d_ff
        out = {"router": ((D, E), ("fsdp", None)),
               "w_up": ((E, D, F), ("expert", "fsdp", "tp_inner")),
               "w_down": ((E, F, D), ("expert", "tp_inner", "fsdp"))}
        if cfg.mlp_type == "swiglu":
            out["w_gate"] = ((E, D, F), ("expert", "fsdp", "tp_inner"))
        if cfg.shared_experts:
            out["shared"] = mlp(F * cfg.shared_experts)
        if cfg.dense_residual:
            out["residual"] = mlp(cfg.dense_d_ff)
        return out

    mixers = {"attn": attn, "cross_attn": attn, "mamba": mamba,
              "mlstm": mlstm, "slstm": slstm}
    if sd.mixer not in mixers:
        raise ValueError(sd.mixer)
    p = {"norm1": norm, "mixer": mixers[sd.mixer]()}
    if sd.ffn != "none":
        p["norm2"] = norm
        p["ffn"] = moe() if sd.ffn == "moe" else mlp(sd.d_ff or cfg.d_ff)
    return p


def _map_leaves(fn, tree: dict) -> dict:
    """`fn((shape, axes))` over a ``sublayer_leaves`` tree."""
    return {k: _map_leaves(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def sublayer_specs(cfg: ModelConfig, R: int, sd: SubDef) -> dict:
    """{name: LeafSpec} of R stacked sublayers `sd`, float32, the JAX
    ``sublayer_init``'s layout with a leading dim R."""
    f32 = np.dtype(np.float32)
    return _map_leaves(lambda leaf: LeafSpec((R,) + leaf[0], f32),
                       sublayer_leaves(cfg, sd))


def sublayer_axes(cfg: ModelConfig, sd: SubDef) -> dict:
    """The logical axes of one sublayer's leaves (no leading repeats
    dim), as the JAX ``sublayer_init`` returns them."""
    return _map_leaves(lambda leaf: leaf[1], sublayer_leaves(cfg, sd))


def lift(tree):
    """Every spec leaf of `tree` with a leading None (the stacked
    repeats dim)."""
    if isinstance(tree, dict):
        return {k: lift(v) for k, v in tree.items()}
    return (None,) + tuple(tree)


class TensorSpec(NamedTuple):
    """Shape and torch dtype of a model input, without memory (the JAX
    package's ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape) -> dict:
    """{name: TensorSpec} of every model input of a ``ShapeConfig``
    cell, for a decoder-only or an encoder-decoder config."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16, ts = torch.int32, torch.bfloat16, TensorSpec
    if shape.kind == "decode":
        return {"tokens": ts((B,), i32), "pos": ts((B,), i32)}
    if cfg.is_encdec:
        out = {"frames": ts((B, S, cfg.d_model), bf16)}
        if shape.kind == "train":
            out.update(tokens=ts((B, S), i32), labels=ts((B, S), i32))
        return out
    T = S - cfg.num_patches if cfg.family == "vlm" else S
    out = {"tokens": ts((B, T), i32)}
    if cfg.family == "vlm":
        out["patches"] = ts((B, cfg.num_patches, cfg.d_model), bf16)
    if shape.kind == "train":
        out["labels"] = ts((B, T), i32)
    return out


def input_logical_specs(cfg: ModelConfig, shape) -> dict:
    """The logical axes of ``input_specs``' entries."""
    if shape.kind == "decode":
        return {"tokens": ("batch",), "pos": ("batch",)}
    spec = {"tokens": ("batch", None), "labels": ("batch", None),
            "patches": ("batch", None, None), "frames": ("batch", None, None)}
    return {k: spec[k] for k in input_specs(cfg, shape)}


def norm_specs(cfg: ModelConfig) -> dict:
    """A final norm's {name: LeafSpec}, float32."""
    f32 = np.dtype(np.float32)
    return _map_leaves(lambda leaf: LeafSpec(leaf[0], f32),
                       _norm_leaves(cfg))


def norm_axes(cfg: ModelConfig) -> dict:
    """A final norm's logical axes."""
    return _map_leaves(lambda leaf: leaf[1], _norm_leaves(cfg))


def param_specs(cfg: ModelConfig) -> dict:
    """Nested {name: LeafSpec} of the JAX package's layout, float32: the
    SHAPES of the parameters (the logical axes are the method
    ``DecoderLM.param_specs()``); for an encoder-decoder config,
    ``models.encdec.param_specs``'s."""
    if cfg.is_encdec:
        from repro_torch.models.encdec import param_specs as encdec_specs
        return encdec_specs(cfg)
    f32 = np.dtype(np.float32)
    V = pad_vocab(cfg.vocab_size)
    tree = {"embed": LeafSpec((V, cfg.d_model), f32)}
    if not cfg.tie_embeddings:
        tree["unembed"] = LeafSpec((V, cfg.d_model), f32)
    for gi, (R, subs) in enumerate(layout(cfg)):
        tree[f"g{gi}"] = {f"s{j}": sublayer_specs(cfg, R, sd)
                          for j, sd in enumerate(subs)}
    tree["final_norm"] = norm_specs(cfg)
    return tree


def flat_specs(tree, prefix=()) -> dict:
    """{path: LeafSpec} of a nested spec tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_specs(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def init_rule(name: str, shape: tuple) -> tuple:
    """(kind, argument) of the JAX package's init for one leaf: ones,
    zeros, ``A_log`` = log(1..N), ``dt_bias`` from a log-uniform dt in
    [1e-3, 1e-1], an xLSTM gate bias of n equal blocks (``b_if``: i, f;
    ``b``: i, f, z, o) whose forget block is 3.0 and the rest zero, or
    a normal with its scale (embeddings 0.02, the Mamba and sLSTM
    ``conv_w`` 0.2, matrices 1/sqrt(fan_in): the sLSTM ``r`` is
    1/sqrt(hd))."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf in ("scale", "D", "norm_scale"):
        return "ones", None
    if leaf in ("b_if", "b"):
        return "forget_bias", 2 if leaf == "b_if" else 4
    if leaf.startswith("b") or leaf == "conv_b":
        return "zeros", None
    if leaf in ("A_log", "dt_bias"):
        return leaf, None
    if name in ("embed", "unembed"):
        return "normal", 0.02
    if leaf == "conv_w":
        return "normal", 0.2
    return "normal", 1.0 / np.sqrt(shape[-2])


def forget_bias(shape: tuple, blocks: int, dtype, device=None):
    """Zeros of `shape` whose last dim's second of `blocks` equal blocks
    (the forget gate's) is 3.0."""
    t = torch.zeros(shape, dtype=dtype, device=device)
    n = shape[-1] // blocks
    t[..., n:2 * n] = 3.0
    return t


def init_flat(cfg: ModelConfig, seed: int) -> dict:
    """Random float32 weights {path: numpy} from `seed`, by the JAX
    package's init rules (``init_rule``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, sp in sorted(flat_specs(param_specs(cfg)).items()):
        kind, scale = init_rule(name, sp.shape)
        if kind == "ones":
            out[name] = np.ones(sp.shape, np.float32)
        elif kind == "zeros":
            out[name] = np.zeros(sp.shape, np.float32)
        elif kind == "A_log":
            out[name] = np.broadcast_to(
                np.log(np.arange(1, sp.shape[-1] + 1, dtype=np.float32)),
                sp.shape).copy()
        elif kind == "dt_bias":
            u = rng.uniform(np.log(1e-3), np.log(1e-1), sp.shape)
            out[name] = np.log(np.expm1(np.exp(u))).astype(np.float32)
        elif kind == "forget_bias":
            out[name] = forget_bias(sp.shape, scale, torch.float32).numpy()
        else:
            w = rng.standard_normal(sp.shape, dtype=np.float32)
            w *= np.float32(scale)
            out[name] = w
    return out


@torch.no_grad()
def init_device(cfg: ModelConfig, seed: int, dtype: str = "bfloat16",
                device="cuda") -> dict:
    """Random weights {path: tensor} drawn on `device` from a
    ``torch.Generator`` seeded with `seed`, by ``init_flat``'s rules,
    each leaf already in the dtype ``DecoderLM.load_flat`` gives it
    (`dtype`, or float32 for ``F32_LEAVES``): a full-width config's
    weights never pass through the host. Not the same draws as
    ``init_flat``."""
    device = resolve_device(device)
    work = getattr(torch, dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, sp in sorted(flat_specs(param_specs(cfg)).items()):
        kind, scale = init_rule(name, sp.shape)
        dt = torch.float32 if name.rsplit("/", 1)[-1] in F32_LEAVES \
            else work
        if kind in ("ones", "zeros"):
            t = (torch.ones if kind == "ones" else torch.zeros)(
                sp.shape, dtype=dt, device=device)
        elif kind == "A_log":
            t = torch.log(torch.arange(1, sp.shape[-1] + 1, device=device,
                                       dtype=torch.float32))
            t = t.expand(sp.shape).to(dt).contiguous()
        elif kind == "dt_bias":
            u = torch.rand(sp.shape, generator=gen, device=device)
            u = u * (np.log(1e-1) - np.log(1e-3)) + np.log(1e-3)
            t = torch.log(torch.expm1(torch.exp(u))).to(dt)
        elif kind == "forget_bias":
            t = forget_bias(sp.shape, scale, dt, device)
        else:
            t = torch.randn(sp.shape, generator=gen, dtype=dt, device=device)
            t.mul_(scale)
        out[name] = t
    return out


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _unstack(tree, R: int) -> list:
    """R per-layer trees of a group's stacked leaves, by one ``unbind``
    per leaf (whose backward stacks the layers' gradients once, where
    indexing each layer would add a full-size gradient per layer)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, R) for k, v in tree.items()}
        return [{k: per[k][r] for k in per} for r in range(R)]
    return tree.unbind(0)


def _dots_policy():
    """``remat="dots"``: a selective checkpoint that saves the outputs
    of 2-D matmuls (the JAX ``dots_with_no_batch_dims_saveable``: a
    weight product of (B, S, D) activations folds to one) and recomputes
    everything else, batched attention products included."""
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )
    saved = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def place(value, sp: LeafSpec, device, dtype) -> torch.Tensor:
    """`value` (numpy or tensor) of spec `sp` as a tensor on `device` in
    `dtype`; a tensor already there in that dtype is not copied."""
    if isinstance(value, torch.Tensor):
        return value.reshape(sp.shape).to(device, dtype)
    arr = np.asarray(value, dtype=np.float32).reshape(sp.shape)
    return torch.from_numpy(np.require(arr, requirements="CW")).to(
        device, dtype)


@torch.no_grad()
def load_tree(specs: dict, flat: dict, device, dtype) -> dict:
    """The nested params of {path: numpy array or tensor} `flat`, which
    must hold exactly the names and shapes of `specs` (raises on a
    missing, extra or misshapen tensor): each leaf on `device` in
    `dtype`, or in float32 for ``F32_LEAVES``."""
    want = flat_specs(specs)
    missing, extra = set(want) - set(flat), set(flat) - set(want)
    if missing or extra:
        raise KeyError(f"load_flat: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    for name, sp in want.items():
        if tuple(np.shape(flat[name])) != sp.shape:
            raise ValueError(f"load_flat: {name} has shape "
                             f"{tuple(np.shape(flat[name]))}, want "
                             f"{sp.shape}")
    params: dict = {}
    for name, sp in want.items():
        *head, leaf = name.split("/")
        node = params
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = place(flat[name], sp, device,
                           torch.float32 if leaf in F32_LEAVES else dtype)
    return params


def remat(flags: RunFlags, run, x: torch.Tensor) -> torch.Tensor:
    """``run(x)`` under the ``flags.remat`` policy (without autograd,
    plainly). A recomputation runs under the sharding policy its forward
    ran under: autograd may recompute on another thread (a CUDA
    device's), where the thread-local policy is not set."""
    from torch.utils.checkpoint import checkpoint

    if flags.remat == "none" or not torch.is_grad_enabled():
        return run(x)
    act = active_policy()
    if act is not None:
        inner = run

        def run(h):
            with use_policy(*act):
                return inner(h)
    if flags.remat == "full":
        return checkpoint(run, x, use_reentrant=False)
    return checkpoint(run, x, use_reentrant=False, context_fn=_dots_policy)


class DecoderLM(nn.Module):
    def __init__(self, cfg: ModelConfig, flags: RunFlags = RunFlags(),
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.flags = flags
        self.device = resolve_device(device)
        self.dtype = getattr(torch, flags.dtype)
        self.layout = layout(cfg)
        self.specs = param_specs(cfg)
        self.params: dict | None = None
        self._groups: list = []      # per group: [per-layer params]

    def param_shapes(self) -> dict:
        """The nested {name: LeafSpec} (shape, float32) of this config's
        parameters, the tree ``tree_from_flat`` rebuilds."""
        return self.specs

    def param_specs(self) -> dict:
        """The LOGICAL AXES of the parameters (the JAX
        ``DecoderLM.param_specs()``): the layout of ``param_shapes()``
        with a tuple of axis names and Nones per leaf (the module-level
        ``param_specs(cfg)`` gives the shapes)."""
        cfg = self.cfg
        tree = {"embed": ("vocab", "fsdp")}
        if not cfg.tie_embeddings:
            tree["unembed"] = ("vocab", "fsdp")
        for gi, (_, subs) in enumerate(self.layout):
            tree[f"g{gi}"] = {f"s{j}": lift(sublayer_axes(cfg, sd))
                              for j, sd in enumerate(subs)}
        tree["final_norm"] = norm_axes(cfg)
        return tree

    def decode_state_spec_tree(self) -> dict:
        """The logical axes of ``init_decode_state``'s tree."""
        return {f"g{gi}": {f"s{j}": lift(decode_state_specs(sd))
                           for j, sd in enumerate(subs)}
                for gi, (_, subs) in enumerate(self.layout)}

    def input_specs(self, shape) -> dict:
        """{name: TensorSpec} of every model input of this cell (no
        memory), as the JAX ``input_specs``."""
        return input_specs(self.cfg, shape)

    def input_logical_specs(self, shape) -> dict:
        return input_logical_specs(self.cfg, shape)

    def load_flat(self, flat: dict) -> "DecoderLM":
        """Load {path: numpy array or tensor}: exactly this config's
        names and shapes (``load_tree``). Tensors already on the device
        in their load dtype are taken without a copy."""
        self.params = load_tree(self.specs, flat, self.device, self.dtype)
        self._groups = [[_index(self.params[f"g{gi}"], r) for r in range(R)]
                        for gi, (R, _) in enumerate(self.layout)]
        return self

    def init_decode_state(self, batch: int, max_len: int,
                          dtype=torch.bfloat16) -> dict:
        """{g{i}: {s{j}: state}}, each leaf stacked (R, ...): KV caches
        (B, max_len, Hkv, hd) and conv windows in `dtype`, SSM and
        xLSTM cell states float32 (module doc)."""
        states = {}
        for gi, (R, subs) in enumerate(self.layout):
            g = {}
            for j, sd in enumerate(subs):
                single = sublayer_decode_state(self.cfg, sd, batch, max_len,
                                               dtype, self.device)
                g[f"s{j}"] = {k: torch.zeros((R,) + tuple(v.shape),
                                             dtype=v.dtype, device=v.device)
                              for k, v in single.items()}
            states[f"g{gi}"] = g
        return states

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg, p = self.cfg, self.params
        x = apply_norm(p["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        table = p["embed"] if cfg.tie_embeddings else p["unembed"]
        return x @ table.to(self.dtype).T

    def _check_loaded(self):
        if self.params is None:
            raise RuntimeError("DecoderLM has no weights: call load_flat")

    def _run(self, x: torch.Tensor, state: dict, mode: str,
             **where) -> torch.Tensor:
        """Every group, layer and sublayer in order; the stacked decode
        state updated in place (a conv window's tensor replaced first
        when its dtype changes, module doc)."""
        cfg, dtype = self.cfg, self.dtype
        for gi, (_, subs) in enumerate(self.layout):
            g_state = state[f"g{gi}"]
            for j, sd in enumerate(subs):
                st = g_state[f"s{j}"]
                if sd.mixer in WINDOWED:
                    conv_dt = dtype if mode == "prefill" \
                        else torch.promote_types(st["conv"].dtype, dtype)
                    st["conv"] = st["conv"].to(conv_dt)
            for r, pl in enumerate(self._groups[gi]):
                for j, sd in enumerate(subs):
                    st = g_state[f"s{j}"]
                    view = {k: v[r] for k, v in st.items()}
                    x, new = sublayer_apply(pl[f"s{j}"], x, cfg, sd, dtype,
                                            mode=mode, state=view,
                                            moe_impl=self.flags.moe_impl,
                                            **where)
                    if new is not view:
                        for k, v in new.items():
                            st[k][r].copy_(v)
        return x

    def _run_train(self, params: dict, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        """Every layer in train mode, each under the ``remat`` policy."""
        cfg, dtype, flags = self.cfg, self.dtype, self.flags
        for gi, (R, subs) in enumerate(self.layout):
            for pl in _unstack(params[f"g{gi}"], R):
                def run(h, pl=pl, subs=subs):
                    for j, sd in enumerate(subs):
                        h, _ = sublayer_apply(
                            pl[f"s{j}"], h, cfg, sd, dtype, mode="train",
                            positions=positions,
                            skip_blocks=flags.skip_masked_blocks,
                            moe_impl=flags.moe_impl)
                    return h
                x = remat(flags, run, x)
            x = logical_constraint(x, ("batch", "seq", None))
        return x

    def _embed(self, params: dict, batch: dict) -> torch.Tensor:
        """The embedded tokens (B, T, D), prefixed with
        ``batch["patches"]`` for a VLM."""
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        x = embed_lookup(params["embed"], tokens, self.dtype)
        if self.cfg.family == "vlm":
            patches = torch.as_tensor(batch["patches"]).to(self.device)
            x = torch.cat([patches.to(self.dtype), x], dim=1)
        return logical_constraint(x, ("batch", "seq", None))

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (both (B, S)), a float32 scalar, as the JAX
        ``DecoderLM.loss`` (a VLM's ``batch["patches"]`` prefixed, their
        rows dropped before the logits). `params` is a nested tree of the JAX
        package's layout (``param_specs``), typically float32 master
        weights that require grad; every use casts to the working dtype,
        so their gradients come out in their own dtype (float32), as
        ``jax.value_and_grad``'s do. Layers run under ``flags.remat``;
        ``flags.chunked_loss`` selects ``chunked_softmax_xent``."""
        cfg, flags, dtype = self.cfg, self.flags, self.dtype
        labels = torch.as_tensor(batch["labels"]).to(self.device)
        x = self._embed(params, batch)
        positions = torch.arange(x.shape[1], device=self.device)
        x = self._run_train(params, x, positions)
        x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        if cfg.family == "vlm":
            x = x[:, cfg.num_patches:]
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        if flags.chunked_loss:
            return chunked_softmax_xent(x, table.to(dtype), labels,
                                        cfg.vocab_size, flags.chunked_loss)
        logits = x @ table.to(dtype).T
        logits = logical_constraint(logits, ("batch", "seq", "vocab"))
        return softmax_xent(logits, labels, cfg.vocab_size)

    @torch.no_grad()
    def prefill(self, batch: dict, state: dict) -> tuple:
        """Full-sequence forward over ``batch["tokens"]`` (B, S) at
        positions 0..S-1 (a VLM's ``batch["patches"]`` (B, P, D) first:
        S counts them) that fills the decode state: returns
        (last-position logits (B, padded vocab) in the working dtype,
        state), the KV caches holding rows [0, S) and the recurrent
        states those after the last row. ``decode_step`` continues at
        position S."""
        self._check_loaded()
        x = self._embed(self.params, batch)
        positions = torch.arange(x.shape[1], device=self.device)
        x = self._run(x, state, "prefill", positions=positions)
        return self._logits(x[:, -1]), state

    @torch.no_grad()
    def decode_step(self, state: dict, tokens: torch.Tensor,
                    pos: torch.Tensor) -> tuple:
        """tokens: (B,) ids; pos: (B,) positions being written. Returns
        (logits (B, padded vocab) in the working dtype, state); the
        decode state is updated in place."""
        self._check_loaded()
        tokens = tokens.to(self.device)
        pos = pos.to(self.device)
        x = embed_lookup(self.params["embed"], tokens, self.dtype)
        x = self._run(x, state, "decode", pos=pos)
        return self._logits(x), state
