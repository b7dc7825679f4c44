"""The paper's §4.2 cold-start drill: empty every cache tier at full load
and show that the system recovers instead of entering the metastable
spiral (the port of the JAX round's ``examples/coldstart_drill.py``).

Four phases of a 300-invocation Zipf trace over 24 functions built on 3
bases: warmup, steady state, a cold restart with every L1 and the L2
flushed, and the phase after it. Each invocation opens its function's
image on one of 4 workers (an ``ImageService`` each, with its own L1,
one shared 6-node L2 and one shared ``RejectingLimiter(8)``: starts
beyond the limit are rejected, not queued) and restores the
``base/common`` tensor (the fused verify+decrypt kernel on the card).
The origin absorbs the refill and the hit rates return to steady state.

Chunks are the system's 512 KiB and each base tensor (4096, 1024)
float32, 32 chunks; the L1s keep the JAX example's ratio of 4 MiB
against a 768 KiB tensor. The population builder and the trace are this
module's copies of the JAX round's ``benchmarks/workload.py``
(``build_population``, publishing through an ``ImageService``, and
``zipf_trace``).

Run: PYTHONPATH=src python -m repro_torch.examples.coldstart_drill
     [--device cuda|cpu] [--functions N] [--invocations N]
     [--rows R --cols C] [--chunk-size N]
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
from dataclasses import dataclass

import numpy as np

from repro_torch.examples import DEVICES, backend_for

JAX_TENSOR_BYTES = 384 * 512 * 4          # the JAX example's base tensor
JAX_L1_BYTES = 4 << 20                    # ... and its L1
BASES, WORKERS, MAX_INFLIGHT = 3, 4, 8    # the JAX example's
# (name, the trace's seed, the banner printed before it)
PHASES = (("warmup", 1, "phase 1: warmup"),
          ("steady", 2, "phase 2: steady state"),
          ("cold restart", 4, "phase 3: DISASTER — all cache tiers flushed"),
          ("post-recovery", 5, "phase 4: recovered?"))


@dataclass
class Population:
    blobs: list
    stats: list
    sizes: list          # image bytes
    tenant_key: bytes


def build_population(service, root, *, n_bases=4, n_functions=60,
                     reupload_frac=0.8, chunk_size=8192, seed=0,
                     base_shape=(384, 512), delta_rows=4) -> Population:
    """Base-model lineage: every function is a base + a small delta;
    `reupload_frac` of uploads are byte-identical to a previous image.
    Image sizes vary (some functions carry extra private layers). Each
    image is published through `service` (the JAX round's
    ``benchmarks.workload.build_population`` with ``create_image``:
    the same draws, manifests and chunks)."""
    rng = np.random.default_rng(seed)
    key = b"W" * 32
    bases = []
    for b in range(n_bases):
        # bases share layers too (common ancestry, like alpine/ubuntu)
        common = rng.standard_normal(base_shape).astype(np.float32)
        own = rng.standard_normal(base_shape).astype(np.float32)
        bases.append((common if b % 2 == 0 else bases[0][0], own))
    blobs, stats, sizes = [], [], []
    originals = []
    for i in range(n_functions):
        if originals and rng.random() < reupload_frac:
            tree = originals[rng.integers(0, len(originals))]
        else:
            common, own = bases[int(rng.integers(0, n_bases))]
            dr = int(rng.integers(1, delta_rows * 2))
            tree = {
                "base/common": common,
                "base/own": own,
                "app/delta": rng.standard_normal(
                    (dr, base_shape[1])).astype(np.float32),
            }
            if rng.random() < 0.25:   # top-quartile-by-size functions
                tree["app/extra"] = rng.standard_normal(
                    (base_shape[0] // 2, base_shape[1])).astype(np.float32)
            originals.append(tree)
        blob, s = service.publish(tree, tenant=f"fn{i}", tenant_key=key,
                                  root=root, chunk_size=chunk_size,
                                  image_id=f"fn{i:04d}")
        blobs.append(blob)
        stats.append(s)
        sizes.append(s.bytes_total)
    return Population(blobs, stats, sizes, key)


def zipf_trace(n_functions: int, length: int, *, a=1.3, seed=1,
               cron_every=200, cron_burst=40):
    """Access trace: Zipf popularity + periodic bursts of cold one-shot
    functions (the paper's cron-spike scan pattern)."""
    rng = np.random.default_rng(seed)
    trace = []
    for t in range(length):
        if cron_every and t % cron_every < cron_burst and t % 5 == 0:
            trace.append(("cron", int(rng.integers(0, n_functions))))
        else:
            f = int(rng.zipf(a)) % max(1, n_functions // 3)
            trace.append(("hot", f))
    return trace


def run_phase(name: str, trace: list, pop: Population, workers: list) -> dict:
    """Every invocation of `trace` on worker ``f % len(workers)``: its
    ``base/common`` restore's simulated read latency (the sum over its
    chunk reads), and the phase's L1 hit rate, origin fraction and
    rejected starts."""
    from repro_torch.core.service import ColdStartRejected
    from repro_torch.core.telemetry import COUNTERS

    names = ("l1.hits", "l1.misses", "read.origin_fetches")
    c0 = {k: COUNTERS.get(k) for k in names}
    lats, rejected = [], 0
    for _kind, f in trace:
        svc = workers[f % len(workers)]
        try:
            with svc.admission_slot():
                h = svc.open(pop.blobs[f % len(pop.blobs)], pop.tenant_key)
                n0 = len(h.reader.read_lat.samples)
                h.restore_tree(["base/common"])
                lats.append(sum(h.reader.read_lat.samples[n0:]))
        except ColdStartRejected:
            rejected += 1
    d = {k: COUNTERS.get(k) - c0[k] for k in names}
    reads = d["l1.hits"] + d["l1.misses"]
    out = {"invocations": len(trace), "reads": reads,
           "p50_ms": float(np.median(lats)) * 1e3,
           "p99_ms": float(np.percentile(lats, 99)) * 1e3,
           "l1_hit_rate": d["l1.hits"] / max(reads, 1),
           "origin_fetches": d["read.origin_fetches"],
           "origin_fraction": d["read.origin_fetches"] / max(reads, 1),
           "rejected": rejected}
    print(f"   {name:18s} p50 {out['p50_ms']:7.2f}ms  "
          f"p99 {out['p99_ms']:7.2f}ms  "
          f"l1 {out['l1_hit_rate']:.2f}  "
          f"origin {out['origin_fraction']:.4f}  "
          f"rejected {rejected}")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.coldstart_drill",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=DEVICES)
    ap.add_argument("--functions", type=int, default=24)
    ap.add_argument("--invocations", type=int, default=300,
                    help="invocations a phase")
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--chunk-size", type=int, default=512 * 1024)
    ap.add_argument("--store", default=None,
                    help="chunk-store dir (default: a temporary one, "
                         "removed at exit)")
    return ap


def main(argv=None) -> dict:
    """Run the drill; returns each phase's figures (``run_phase``), the
    L1 size and the population's image stats."""
    args = build_parser().parse_args(argv)

    from repro_torch.core.cache.distributed import DistributedCache
    from repro_torch.core.cache.local import LocalCache
    from repro_torch.core.concurrency import RejectingLimiter
    from repro_torch.core.gc import GenerationalGC
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    from repro_torch.kernels.gf256.ops import rs_matmul_fn
    from repro_torch.kernels.parity.ops import parity_fn_for_erasure

    backend = backend_for(args.device)
    l1_bytes = JAX_L1_BYTES * (args.rows * args.cols * 4) // JAX_TENSOR_BYTES
    out = {"l1_bytes": l1_bytes, "phases": {}}
    with contextlib.ExitStack() as stack:
        store = ChunkStore(args.store or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro-drill-")))
        gc = GenerationalGC(store)
        publisher = ImageService(store, ServiceConfig(
            device=args.device, decode_backend=backend, l1_bytes=0,
            publish_warm_l1=False))
        stack.callback(publisher.close)
        pop = build_population(publisher, gc.active,
                               n_functions=args.functions,
                               n_bases=BASES,
                               chunk_size=args.chunk_size,
                               base_shape=(args.rows, args.cols))
        out["images"] = [{"image_id": s.image_id,
                          "total_chunks": s.total_chunks,
                          "unique_chunks": s.unique_chunks,
                          "dedup_chunks": s.dedup_chunks}
                         for s in pop.stats]
        l1s = [LocalCache(l1_bytes, name="l1") for _ in range(WORKERS)]
        l2 = DistributedCache(num_nodes=6, seed=3,
                              parity_fn=parity_fn_for_erasure(args.device),
                              matmul_fn=rs_matmul_fn(args.device))
        lim = RejectingLimiter(MAX_INFLIGHT)
        workers = [ImageService(store, ServiceConfig(
            device=args.device, decode_backend=backend),
            l1=l1, l2=l2, admission=lim) for l1 in l1s]
        for w in workers:
            stack.callback(w.close)
        print(f"== {args.functions} functions on {BASES} bases, "
              f"{WORKERS} workers (L1 {l1_bytes / 2**20:.2f} MiB each), "
              f"6-node L2, RejectingLimiter({MAX_INFLIGHT}) ==")
        for name, seed, banner in PHASES:
            print(f"== {banner} ==")
            if name == "cold restart":
                l2.flush()
                for l1 in l1s:
                    l1.lru.data.clear()
                    l1.lru.used = 0
            out["phases"][name] = run_phase(
                name, zipf_trace(args.functions, args.invocations,
                                 seed=seed), pop, workers)
        print("   (origin fraction back to ~steady-state => no metastable "
              "spiral)")
    return out


if __name__ == "__main__":
    main()
