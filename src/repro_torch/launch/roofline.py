"""Roofline terms of one traced step on the NVIDIA H100 (the port of
``repro.launch.roofline``).

The JAX package parses the optimized XLA HLO of a step. The port has no
HLO: it runs the step once under ``StepCounter``, a
``TorchDispatchMode`` that sees every operator one rank runs, and counts

  * dot FLOPs          (``torch.utils.flop_counter``'s formulas: mm, bmm,
                        addmm, baddbmm, the SDPA kernels, forward and
                        backward)
  * bytes accessed     (operand + result bytes of every operator that is
                        not a view: an UNFUSED upper bound, since eager
                        PyTorch fuses nothing, where XLA's count skips
                        fusion internals)
  * collective bytes   (ring-model per-rank traffic of the functional
                        collectives, ``ring_bytes``, by kind)
  * live bytes         (the peak of storages allocated during the step)

What it counts is WHAT ONE RANK RUNS, as the JAX package's per-device
module: a DTensor operator is left to DTensor (the mode declines it),
whose local operators and redistributing collectives on the local
shards then come back to the mode; the global-shape operators DTensor
runs on fake tensors to propagate shapes are skipped. Under a
``FakeTensorMode`` nothing is computed or allocated, so a full-width
step on a fake 256-rank mesh counts in one process (``launch.dryrun``).

Hardware constants: NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU data
sheet): 989.4 TFLOP/s dense BF16 tensor-core peak, 3.35 TB/s HBM3;
NVLink 4, 900 GB/s per GPU in both directions, so 450 GB/s per
direction for a group within one node of 8 GPUs; for a group that spans
nodes, one 400 Gb/s NIC per GPU, 50 GB/s.
"""
from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NIC_BW = 50e9
NODE_GPUS = 8

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collective -> (kind, the result is a list)
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
}
# allocate without reading or writing memory
_EMPTY = {"empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided"}
_NO_TRAFFIC = {"wait_tensor", "detach", "alias", "lift_fresh", "device",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
               "is_same_size", "_local_scalar_dense"}
_SHARDING_PROP = "torch/distributed/tensor/_sharding_prop.py"


def ring_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Per-rank traffic of one collective over n ranks in the ring model
    (the JAX analyzer's formulas): an all-gather moves (n-1)/n of its
    full result, an all-reduce twice that, a reduce-scatter (n-1) times
    its scattered result, an all-to-all (n-1)/n of its result, a
    collective-permute its result."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (n - 1) / n
    if kind == "all-reduce":
        return 2 * result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-to-all":
        return result_bytes * (n - 1) / n
    return result_bytes  # collective-permute


def link_bw(ranks) -> float:
    """NVLink within one node of ``NODE_GPUS``, a NIC across nodes."""
    nodes = {r // NODE_GPUS for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NIC_BW


def _nbytes(tree) -> int:
    leaves = torch.utils._pytree.tree_leaves(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _group(args, kwargs):
    """(size, ranks) of the process group a functional collective names
    (its last string argument)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = [a for a in list(args) + list(kwargs.values())
            if isinstance(a, str)][-1]
    pg = _resolve_process_group(name)
    ranks = dist.get_process_group_ranks(pg)
    return len(ranks), ranks


@dataclass
class Costs:
    dot_flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0        # per-rank ring traffic
    collective_detail: dict = field(default_factory=dict)
    collective_s: float = 0.0            # at each group's link bandwidth
    ops: int = 0
    peak_live_bytes: int = 0             # storages allocated in the step


class StepCounter(TorchDispatchMode):
    """Counts what one rank runs (module doc). ``costs`` holds the
    totals; ``known`` storages (the step's arguments) are not counted as
    allocated by the step."""

    def __init__(self, known=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.costs = Costs()
        self._known = {id(t.untyped_storage()) for t in known}
        self._tracked: dict = {}
        self._live = 0

    def _propagating(self) -> bool:
        f = sys._getframe(2)
        while f is not None:
            if f.f_code.co_filename.endswith(_SHARDING_PROP):
                return True
            f = f.f_back
        return False

    def _free(self, key, n):
        self._tracked.pop(key, None)
        self._live -= n

    def _track(self, out):
        for t in torch.utils._pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._known or key in self._tracked:
                continue
            n = st.nbytes()
            self._tracked[key] = n
            self._live += n
            weakref.finalize(st, self._free, key, n)
        self.costs.peak_live_bytes = max(self.costs.peak_live_bytes,
                                         self._live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs the local ops
        out = func(*args, **kwargs)
        if self._propagating():
            return out
        name = func.__name__.split(".")[0]
        c = self.costs
        c.ops += 1
        kind = _COLLECTIVE_OPS.get(name) \
            if func.namespace.startswith("_c10d_functional") else None
        if kind:
            n, ranks = _group(args, kwargs)
            moved = ring_bytes(kind, _nbytes(out), n)
            c.collective_bytes += moved
            c.collective_detail[kind] = c.collective_detail.get(kind, 0.0) \
                + moved
            c.collective_s += moved / link_bw(ranks)
        packet = func.overloadpacket
        if packet in self._flops:
            c.dot_flops += self._flops[packet](*args, **kwargs, out_val=out)
        if not (func.is_view or name in _NO_TRAFFIC or name in _EMPTY):
            c.bytes_accessed += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        if not func.is_view:
            self._track(out)
        return out


def _local_tensors(tree) -> list:
    from torch.distributed.tensor import DTensor

    out = []
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, DTensor):
            out.append(t.to_local())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def count_step(fn, *args):
    """(fn(*args), Costs) of one call counted by ``StepCounter``; the
    storages of `args` (their local shards) are the step's arguments."""
    counter = StepCounter(known=_local_tensors(args))
    with counter:
        out = fn(*args)
    return out, counter.costs


@dataclass
class Roofline:
    """Per-step roofline terms, in seconds. All quantities are PER RANK:
    the counted operators are one rank's local program."""
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes: float
    collective_bytes: float
    collective_detail: dict
    model_flops: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (per-rank model share vs run)."""
        per_chip_model = self.model_flops / self.chips
        return per_chip_model / self.flops if self.flops else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline-projected step time."""
        per_chip_model = self.model_flops / self.chips
        t = self.step_time_s
        return per_chip_model / (t * PEAK_FLOPS) if t else 0.0

    def to_dict(self):
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "flops": self.flops,
            "bytes": self.bytes, "collective_bytes": self.collective_bytes,
            "collective_detail": self.collective_detail,
            "model_flops": self.model_flops, "chips": self.chips,
            "dominant": self.dominant, "mfu": self.mfu,
            "useful_fraction": self.useful_fraction,
            "step_time_s": self.step_time_s,
        }


def roofline_from_costs(c: Costs, chips: int, model_flops: float) -> Roofline:
    """The counted costs are one rank's, so already per chip."""
    return Roofline(
        compute_s=c.dot_flops / PEAK_FLOPS,
        memory_s=c.bytes_accessed / HBM_BW,
        collective_s=c.collective_s,
        flops=c.dot_flops,
        bytes=c.bytes_accessed,
        collective_bytes=c.collective_bytes,
        collective_detail=dict(c.collective_detail),
        model_flops=model_flops,
        chips=chips,
    )
