"""Replica cold start via on-demand chunk loading (the port of
``repro.serve.coldstart.cold_start``; the expert-shard restore is a
later slice).

``cold_start`` takes an admission slot from the shared
``ImageService`` (excess starts raise ``ColdStartRejected``), opens the
image as a tenant session, restores the weights through the service's
tiers under one ``ReadPolicy``, promotes float64 leaves to float32,
loads them into the model (``DecoderLM.load_flat``) and stands up a
``ServeEngine``."""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.service import ImageService, ReadPolicy
from repro_torch.serve.engine import ServeEngine


def cold_start(model, manifest_blob: bytes, tenant_key: bytes,
               service: ImageService, *, root=None, tenant=None,
               policy: ReadPolicy | None = None, max_batch: int = 4,
               max_len: int = 128) -> tuple:
    """Returns (engine, stats): ``load_seconds`` (open + restore + load
    into the model), the restore's fetch/decode split, overlap and L2
    hits, and ``restore_seconds`` (open + restore only)."""
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
