"""Elastic training coordination (single-process fleet simulation; the
port of ``repro.train.elastic``, whole).

The paper's thesis applied to training recovery: replacing a failed worker
is fast because its weight shard demand-loads from the content-addressed
cache hierarchy — bounded by *shard* bytes (1/TP of the image) with warm
L2, not by image bytes. The coordinator here owns:

  * heartbeat-based failure detection,
  * shard-aware recovery planning (which chunks the replacement needs),
  * elastic re-scaling: dropping the data-parallel degree keeps the run
    alive when spare capacity is short (batch is re-sharded, model shards
    unchanged),
  * straggler detection from per-step latency quantiles (mitigation at
    the storage layer is the constant-work erasure fetch, which makes
    fetch work identical in failure and success cases).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.telemetry import COUNTERS


@dataclass
class WorkerSim:
    worker_id: str
    data_rank: int
    model_rank: int
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.time)
    step_latencies: list = field(default_factory=list)


class ElasticCoordinator:
    def __init__(self, data_parallel: int, model_parallel: int,
                 heartbeat_timeout: float = 5.0):
        self.dp, self.mp = data_parallel, model_parallel
        self.timeout = heartbeat_timeout
        self.workers = {
            f"w-{d}-{m}": WorkerSim(f"w-{d}-{m}", d, m)
            for d in range(data_parallel) for m in range(model_parallel)}
        self.events: list = []

    # ----------------------------------------------------------- liveness
    def heartbeat(self, worker_id: str, step_latency: float | None = None,
                  now: float | None = None):
        w = self.workers[worker_id]
        w.last_heartbeat = now if now is not None else time.time()
        if step_latency is not None:
            w.step_latencies.append(step_latency)

    def detect_failures(self, now: float | None = None) -> list:
        now = now if now is not None else time.time()
        failed = [w.worker_id for w in self.workers.values()
                  if w.alive and now - w.last_heartbeat > self.timeout]
        for wid in failed:
            self.workers[wid].alive = False
            self.events.append(("failure", wid))
            COUNTERS.inc("elastic.failures_detected")
        return failed

    def kill(self, worker_id: str):
        self.workers[worker_id].alive = False
        self.events.append(("killed", worker_id))

    # ---------------------------------------------------------- stragglers
    def stragglers(self, factor: float = 3.0, min_samples: int = 5) -> list:
        all_lat = [l for w in self.workers.values() for l in w.step_latencies]
        if len(all_lat) < min_samples:
            return []
        p50 = float(np.percentile(all_lat, 50))
        out = []
        for w in self.workers.values():
            if len(w.step_latencies) >= min_samples and w.alive:
                if float(np.median(w.step_latencies[-min_samples:])) > factor * p50:
                    out.append(w.worker_id)
        for wid in out:
            self.events.append(("straggler", wid))
            COUNTERS.inc("elastic.stragglers_flagged")
        return out

    # ----------------------------------------------------------- recovery
    def plan_recovery(self, failed_id: str, reader, param_specs_fn) -> dict:
        """Chunks a replacement worker must fetch for the failed worker's
        shard. `reader`: an ``ImageHandle`` or ``ImageReader`` over the
        latest checkpoint;
        `param_specs_fn(name, shape) -> (dp_shards, mp_shards) per-dim grid`.
        """
        w = self.workers[failed_id]
        shard_slices = {}
        for name in reader.tensor_names():
            t = reader.layout.tensors[name]
            grid = param_specs_fn(name, t.shape)
            coords = []
            sizes = []
            for dim_grid in grid:
                sizes.append(dim_grid)
            coords = [w.model_rank % g if g > 1 else 0 for g in sizes]
            shard_slices[name] = [
                ((dim // g) * c, (dim // g) * (c + 1) if c < g - 1 else dim)
                for dim, g, c in zip(t.shape, sizes, coords)]
        chunks = reader.shard_chunks(shard_slices)
        total = reader.layout.num_chunks
        plan = {"worker": failed_id, "chunks": chunks,
                "chunk_fraction": len(chunks) / max(1, total),
                "shard_slices": shard_slices}
        self.events.append(("recovery_planned", failed_id, len(chunks)))
        return plan

    def execute_recovery(self, plan: dict, reader) -> dict:
        """Demand-fetch the shard chunks (through whatever cache tiers the
        reader has), spawn the replacement, return timing/bytes stats."""
        t0 = time.time()
        before = COUNTERS.get("read.origin_fetches")
        reader.prefetch(plan["chunks"])
        elapsed = time.time() - t0
        origin = COUNTERS.get("read.origin_fetches") - before
        wid = plan["worker"]
        self.workers[wid].alive = True
        self.workers[wid].last_heartbeat = time.time()
        self.events.append(("recovered", wid, elapsed))
        COUNTERS.inc("elastic.recoveries")
        return {"seconds": elapsed, "chunks": len(plan["chunks"]),
                "origin_fetches": origin,
                "chunk_fraction": plan["chunk_fraction"]}

    # ------------------------------------------------------------ rescale
    def rescale_plan(self, target_dp: int) -> dict:
        """Elastic re-scale of the data axis: global batch resharded,
        model shards untouched (no weight movement)."""
        old = self.dp
        self.dp = target_dp
        self.events.append(("rescale", old, target_dp))
        COUNTERS.inc("elastic.rescales")
        return {"old_dp": old, "new_dp": target_dp,
                "batch_per_replica_factor": old / target_dp,
                "weights_moved_bytes": 0}
