"""Logical-axis -> mesh-axis translation (the port of
``repro.sharding.rules``), on ``torch.distributed``'s ``DeviceMesh``
and DTensor.

Model code names each array's axes with *logical* names ("batch",
"fsdp", "tp", "expert", ...). A ``ShardingPolicy`` decides which mesh
axes each logical name maps to. The baseline policy is Megatron-style TP
on `model`, ZeRO/FSDP on `data` and pure DP across `pod`; the variants
swap these mappings without touching model code.

A mapping that does not divide its dim (smollm's 15 heads on a 16-way
axis, whisper's kv_heads=8) is dropped for that dim: the translation is
shape-aware, as the JAX package's is.

``logical_to_pspec`` returns the port's ``PartitionSpec``, a tuple of
mesh-axis names (or tuples of them, or None) compared by content.
``specs_to_shardings`` returns a tree of ``NamedSharding``s, each a
(``DeviceMesh``, DTensor placements) pair: a tensor dim mapped to mesh
axes is ``Shard(dim)`` on each of them, every other mesh dim is
``Replicate()``. ``distribute_tree`` places a tree of tensors as
DTensors by such a tree. A mesh here is a ``DeviceMesh`` with dim names,
or anything whose ``shape`` maps axis names to sizes (a dict or the
tests' stand-ins)."""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class ShardingPolicy:
    """Which mesh axes each logical axis name maps to."""
    rules: dict = field(default_factory=lambda: dict(DEFAULT_RULES))
    name: str = "baseline"

    def with_rules(self, name: str = "", **updates) -> "ShardingPolicy":
        r = dict(self.rules)
        r.update(updates)
        return ShardingPolicy(rules=r, name=name or self.name)


DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
    "tp_inner": (),            # second shard dim inside an expert
    "heads": ("model",),
    "kv_heads": ("model",),
    "expert": ("model",),
    "vocab": ("model",),
    "seq": (),                 # sequence parallelism (opt-in)
    "kv_seq": (),              # KV-cache sequence sharding (opt-in)
}


class PartitionSpec(tuple):
    """One entry per leading tensor dim: a mesh-axis name, a tuple of
    them, or None (trailing Nones stripped), as ``jax.sharding.
    PartitionSpec`` holds them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on `mesh`: its ``spec`` and the DTensor
    ``placements`` (one per mesh dim) that realise it."""
    mesh: object
    spec: PartitionSpec
    placements: tuple


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (by its dim names) or of a
    mesh-like object whose ``shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def is_spec(x) -> bool:
    """A logical spec leaf: None or a tuple of names and Nones."""
    return x is None or (isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x))


def _mesh_axes(shape: dict, logical, policy: ShardingPolicy) -> tuple:
    if logical is None:
        return ()
    return tuple(a for a in policy.rules.get(logical, ()) if a in shape)


def logical_to_pspec(axes, shape, mesh, policy: ShardingPolicy):
    """Translate a tuple of logical names to a PartitionSpec, dropping any
    mapping that does not evenly divide its dim, and never assigning one
    mesh axis to two dims (first dim wins — e.g. xlstm's (tp, heads))."""
    sizes = mesh_shape(mesh)
    out = []
    used: set = set()
    for dim, logical in zip(shape, axes):
        mapped = _mesh_axes(sizes, logical, policy)
        mapped = tuple(a for a in mapped if a not in used)
        size = 1
        for a in mapped:
            size *= sizes[a]
        if mapped and size > 1 and dim % size == 0:
            out.append(mapped if len(mapped) > 1 else mapped[0])
            used.update(mapped)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def pspec_to_placements(pspec, mesh) -> tuple:
    """The DTensor placements of `pspec` on `mesh`: ``Shard(d)`` on each
    mesh dim that tensor dim d maps to, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def sharding_of(axes, shape, mesh, policy: ShardingPolicy) -> NamedSharding:
    """The ``NamedSharding`` of one array of `shape` with logical
    `axes` (None: replicated)."""
    pspec = P() if axes is None else logical_to_pspec(tuple(axes), shape,
                                                      mesh, policy)
    return NamedSharding(mesh, pspec, pspec_to_placements(pspec, mesh))


def map2(fn, specs, shapes, is_leaf=is_spec):
    """`fn(leaf, other leaf)` over two trees of the same nesting (dicts
    and lists; `specs`' leaves are those `is_leaf` accepts: logical
    specs by default)."""
    if is_leaf(specs):
        return fn(specs, shapes)
    if isinstance(specs, dict):
        return {k: map2(fn, specs[k], shapes[k], is_leaf) for k in specs}
    if isinstance(specs, (list, tuple)):
        return type(specs)(map2(fn, s, t, is_leaf)
                           for s, t in zip(specs, shapes))
    raise TypeError(f"not a logical spec: {specs!r}")


def specs_to_shardings(spec_tree, shape_tree, mesh, policy: ShardingPolicy):
    """A ``NamedSharding`` tree for (logical spec tree, tree of leaves
    with a ``shape``: tensors, ``LeafSpec``s, ``TensorSpec``s)."""
    return map2(lambda axes, leaf: sharding_of(axes, tuple(leaf.shape),
                                                mesh, policy),
                 spec_tree, shape_tree)


def distribute_tree(tree, shardings):
    """`tree`'s tensors as DTensors placed by the ``NamedSharding`` tree
    `shardings` (from ``specs_to_shardings``); each tensor holds the
    global value, every rank keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(shardings, NamedSharding):
        return distribute_tensor(tree, shardings.mesh,
                                 list(shardings.placements))
    if isinstance(shardings, dict):
        return {k: distribute_tree(tree[k], shardings[k]) for k in shardings}
    return type(shardings)(distribute_tree(t, s)
                           for t, s in zip(tree, shardings))


def local_nbytes(t: torch.Tensor) -> int:
    """Bytes this rank holds of `t` (its local shard for a DTensor)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()
