"""Replica cold start via on-demand chunk loading, and the restore of an
expert-parallel worker's shard (the port of ``repro.serve.coldstart``).

``cold_start`` takes an admission slot from the shared
``ImageService`` (excess starts raise ``ColdStartRejected``), opens the
image as a tenant session, restores the weights through the service's
tiers under one ``ReadPolicy``, promotes float64 leaves to float32,
loads them into the model (``load_flat`` of a ``DecoderLM`` or an
``EncDecModel``) and stands up a ``ServeEngine``.

``expert_shard_restore`` restores what one expert-parallel worker
holds: its own experts' slices of every expert stack and every other
tensor whole, in one batched ``restore_shards``. It finds the expert
stacks by parameter path (``.../ffn/w_gate|w_up|w_down`` whose dim
before the (in, out) matrix has ``num_experts`` entries). The JAX
package takes the first dim of any rank >= 3 tensor whose size equals
``num_experts``, which also slices a MoE router (R, D, E) and the Mamba
tensors whose d_state, d_conv or dt_rank equals the expert count; the
worker needs those whole (ROADMAP.md §3)."""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.blockdev import DEFAULT_PARALLELISM
from repro_torch.core.service import ImageService, ReadPolicy
from repro_torch.serve.engine import ServeEngine

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def cold_start(model, manifest_blob: bytes, tenant_key: bytes,
               service: ImageService, *, root=None, tenant=None,
               policy: ReadPolicy | None = None, max_batch: int = 4,
               max_len: int = 128) -> tuple:
    """Returns (engine, stats): ``load_seconds`` (open + restore + load
    into the model), the restore's fetch/decode split, overlap and L2
    hits, its simulated serial and pipelined seconds, the reader's
    median simulated chunk latency, and ``restore_seconds`` (open +
    restore only)."""
    with service.admission_slot():
        t0 = time.perf_counter()
        handle = service.open(manifest_blob, tenant_key, root=root,
                              tenant=tenant)
        before_origin = handle.counters.get("read.origin_fetches")
        flat = handle.restore_tree(policy=policy)
        t_restore = time.perf_counter() - t0
        flat = {k: v.astype(np.float32) if v.dtype == np.float64 else v
                for k, v in flat.items()}
        model.load_flat(flat)
        if model.device.type == "cuda":
            import torch
            torch.cuda.synchronize(model.device)
        t_load = time.perf_counter() - t0
        engine = ServeEngine(model, max_batch=max_batch, max_len=max_len)
        lb = handle.reader.last_batch
        stats = {
            "load_seconds": t_load,
            "restore_seconds": t_restore,
            "tenant": handle.tenant,
            "origin_fetches": handle.counters.get("read.origin_fetches")
            - before_origin,
            "image_bytes": handle.layout.image_size,
            "l2_sim_latency_p50": handle.reader.read_lat.percentile(50),
            "sim_pipelined_s": lb.get("sim_pipelined_s"),
            "sim_serial_s": lb.get("sim_serial_s"),
            "fetch_wall_s": lb.get("fetch_wall_s"),
            "decode_wall_s": lb.get("decode_wall_s"),
            "decode_backend": lb.get("decode_backend"),
            "streamed": lb.get("streamed"),
            "overlap_s": lb.get("overlap_s"),
            "overlap_fraction": lb.get("overlap_fraction"),
            "queue_hwm": lb.get("queue_hwm"),
            "decode_tiles": lb.get("decode_tiles"),
            "eager_flushes": lb.get("eager_flushes"),
            "l2_hits": lb.get("l2_hits"),
        }
        return engine, stats


def expert_dim(name: str, shape: tuple, num_experts: int):
    """The expert dim of tensor `name` (the dim before its (in, out)
    matrix), or None for a tensor every worker holds whole."""
    parts = name.split("/")
    if len(parts) < 2 or parts[-2] != "ffn" \
            or parts[-1] not in EXPERT_LEAVES or len(shape) < 3:
        return None
    edim = len(shape) - 3
    return edim if shape[edim] == num_experts else None


def expert_shard_slices(tensors: dict, num_experts: int, ep_rank: int,
                        ep_size: int) -> dict:
    """{name: dim slices, or None for the whole tensor} of what rank
    `ep_rank` of `ep_size` holds: experts [lo, hi) of every expert
    stack, every other tensor whole. `tensors`: {name: anything with a
    ``shape``}, e.g. an image layout's ``tensors``."""
    lo = num_experts * ep_rank // ep_size
    hi = num_experts * (ep_rank + 1) // ep_size
    out = {}
    for name, t in tensors.items():
        edim = expert_dim(name, t.shape, num_experts)
        if edim is None:
            out[name] = None
        else:
            sl = [(0, d) for d in t.shape]
            sl[edim] = (lo, hi)
            out[name] = sl
    return out


def expert_shard_restore(reader, num_experts: int,
                         ep_rank: int, ep_size: int,
                         parallelism: int = DEFAULT_PARALLELISM,
                         policy: ReadPolicy | None = None) -> dict:
    """{name: array} of ``expert_shard_slices`` (module doc). `reader`
    is an ``ImageHandle`` (or the ``ImageReader`` shim); every byte
    range goes into one batched ``restore_shards`` under `policy`
    (default: a streamed policy at `parallelism`)."""
    if policy is None:
        policy = ReadPolicy(parallelism=parallelism)
    tensors = {n: reader.layout.tensors[n] for n in reader.tensor_names()}
    return reader.restore_shards(
        expert_shard_slices(tensors, num_experts, ep_rank, ep_size),
        policy=policy)
