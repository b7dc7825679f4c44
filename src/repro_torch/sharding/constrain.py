"""In-graph sharding constraints from logical axis names (the port of
``repro.sharding.constrain``).

``use_policy(mesh, policy)`` installs a (mesh, policy) pair for the
calling thread; model code calls ``logical_constraint(x, ("batch",
None, "tp"))``, which redistributes a DTensor to the policy's layout
when a policy is active and is a no-op otherwise, or on a plain tensor
(one device, the CPU tests).

``force_replicate(x, site)`` and ``split_last`` are the places the port
gathers a DTensor on purpose (where DTensor has no sharding rule the
step can use); each redistribution is counted by site in ``FORCED``,
which the dry run prints, so no replication is silent.
``local_shard_map`` is ``shard_map`` on DTensors: a function of each
rank's local shards, with ``shard_map``'s gradients."""
from __future__ import annotations

import threading
from collections import Counter
from contextlib import contextmanager

import torch

from repro_torch.sharding.rules import (
    ShardingPolicy,
    logical_to_pspec,
    pspec_to_placements,
)

_state = threading.local()
FORCED: Counter = Counter()


def active_policy():
    return getattr(_state, "active", None)


@contextmanager
def use_policy(mesh, policy: ShardingPolicy):
    prev = getattr(_state, "active", None)
    _state.active = (mesh, policy)
    try:
        yield
    finally:
        _state.active = prev


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def as_dtensor(t, mesh):
    """`t` as a DTensor on `mesh`: a plain tensor (the same on every
    rank: positions, lengths, tokens) is taken as replicated."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def logical_constraint(x, axes):
    act = active_policy()
    if act is None or not is_dtensor(x):
        return x
    mesh, policy = act
    pspec = logical_to_pspec(tuple(axes), x.shape, mesh, policy)
    placements = pspec_to_placements(pspec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, list(placements))


def force_replicate(x, site: str):
    """`x` replicated on every mesh dim (a redistribution counted in
    ``FORCED[site]``); a plain or already replicated tensor is returned
    as it is."""
    from torch.distributed.tensor import Replicate

    if not is_dtensor(x) or all(isinstance(p, Replicate)
                                 for p in x.placements):
        return x
    FORCED[site] += 1
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward scales the gradient by `s`."""

    @staticmethod
    def forward(ctx, x, s: float):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def local_shard_map(fn, mesh, in_specs: tuple, out_spec):
    """``shard_map`` on DTensors (``local_map``): `fn` runs on each
    rank's local shards of its DTensor arguments, laid out by
    `in_specs` (``PartitionSpec``s, or tuples of DTensor placements; the
    arguments are redistributed to them), and its one result is taken as
    the local shard of `out_spec`.

    Gradients follow ``shard_map``'s transpose: an argument's gradient
    is a partial sum over every mesh axis the argument is replicated on
    (each rank's local backward holds its share), and the result's
    gradient is divided by the size of every mesh axis the result is
    replicated on (each of those ranks computed the whole result)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import PartitionSpec, pspec_to_placements

    def placements(spec):
        if isinstance(spec, PartitionSpec):
            return pspec_to_placements(spec, mesh)
        return tuple(spec)
    ins = [placements(s) for s in in_specs]
    out = placements(out_spec)
    grads = [tuple(Partial() if isinstance(p, Replicate) else p for p in pl)
             for pl in ins]
    n_rep = 1
    for size, p in zip(tuple(mesh.shape), out):
        if isinstance(p, Replicate):
            n_rep *= size

    def body(*args):
        y = fn(*args)
        return _ScaleGrad.apply(y, 1.0 / n_rep) if n_rep > 1 else y

    return local_map(body, out_placements=list(out), in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)


def split_last(x, shape: tuple, site: str):
    """``x.reshape(shape)`` where `shape` splits x's last dim. A DTensor
    sharded on that dim over n ranks whose new leading factor n does
    not divide (smollm's 15 heads, kimi's 8 KV heads on a 16-way axis,
    where the projection's columns do divide) cannot be split in place:
    that dim is first gathered (its mesh dims made ``Replicate()``,
    counted in ``FORCED[site]``), as XLA reshards it."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        d = x.ndim - 1
        mesh = x.device_mesh
        n = 1
        for size, p in zip(tuple(mesh.shape), x.placements):
            if isinstance(p, Shard) and p.dim == d:
                n *= size
        if n > 1 and shape[d] % n:
            FORCED[site] += 1
            x = x.redistribute(mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == d else p
                for p in x.placements])
    return x.reshape(shape)
