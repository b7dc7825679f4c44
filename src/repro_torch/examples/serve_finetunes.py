"""Serve a fleet of fine-tunes from one base model — the paper's
multi-tenant story mapped to model serving (the port of the JAX round's
``examples/serve_finetunes.py``).

Ten fine-tunes of SmolLM-360M at full width (one tenant and tenant key
each; fine-tune i changes tensor ``sorted(tree)[i]``) are published
into one store, then every replica cold-starts through ONE shared
``ImageService``: a shared L1 sized to hold the base image, a 6-node
erasure-coded L2 (its parity and GF(256) hooks on the service's
device), admission control and per-tenant scoped telemetry. Convergent
encryption dedups the base's chunks across tenants, so the fleet's
origin traffic is bounded by the distinct chunks (each tenant's scoped
counters show the cross-tenant L1 hits), and the L2 serves the chunks
the L1 evicted even with node ``cache-000`` failed before the fourth
start.

The port's choices: the L2 hedges its stripe GETs, so a stripe past
the 20 ms deadline on a surviving node does not send a chunk to the
origin while a node is down, and its flash tier holds the fleet's
stripes. The publisher is a service of its own
with no L1, so the fleet starts cold as the JAX example's. The L1
keeps every base chunk once two replicas have read it (LRU-K, k = 2),
so at these sizes no chunk is read back from the L2: each first fetch
probes it, misses, and fills it from the origin (the parity kernel,
one launch per origin GET).

Run: PYTHONPATH=src python -m repro_torch.examples.serve_finetunes
     [--device cuda|cpu] [--reduced] [--fine-tunes N] [--dtype D]
     [--chunk-size N] [--l1-bytes N] [--store DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile

import numpy as np

from repro_torch.examples import DEVICES, backend_for

FAIL_BEFORE = 3          # node cache-000 fails before the fourth start
L2_FLASH_BYTES = 2 << 30  # each L2 node's flash tier: the fleet's stripes
PROMPT = [11, 22, 33]
MAX_NEW = 4


def tenant_key(i: int) -> bytes:
    return b"%02d" % i * 16


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_finetunes",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=DEVICES)
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-sized reduced config")
    ap.add_argument("--fine-tunes", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="the replicas' serving dtype")
    ap.add_argument("--chunk-size", type=int, default=512 * 1024)
    ap.add_argument("--l1-bytes", type=int, default=1536 << 20,
                    help="the shared L1 (default 1.61 GB: it holds the "
                         "1.449 GB base image)")
    ap.add_argument("--store", default=None,
                    help="chunk-store dir (default: a temporary one, "
                         "removed at exit)")
    return ap


def fine_tunes(base: dict, n: int) -> list:
    """Fine-tune i: `base` with tensor ``sorted(base)[i]`` plus 0.01 x a
    normal draw from one seed-0 generator (the JAX example's rule)."""
    rng = np.random.default_rng(0)
    names = sorted(base)
    out = []
    for i in range(n):
        ft = dict(base)
        victim = names[i % len(names)]
        ft[victim] = ft[victim] + rng.standard_normal(
            ft[victim].shape).astype(ft[victim].dtype) * 0.01
        out.append((victim, ft))
    return out


def main(argv=None, *, weights: dict | None = None,
         on_replica=None) -> dict:
    """Publish the fine-tunes, cold-start and serve one replica each.
    `weights` replaces the base weights drawn from seed 0;
    ``on_replica(i, engine, stats, tree)`` is called after replica i
    served, before the next starts (the model is shared). Returns every
    figure printed."""
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.cache.distributed import DEFAULT_HEDGE_QUANTILE, \
        DistributedCache
    from repro_torch.core.gc import GenerationalGC
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    from repro_torch.core.telemetry import COUNTERS
    from repro_torch.kernels.gf256.ops import rs_matmul_fn
    from repro_torch.kernels.parity.ops import parity_fn_for_erasure
    from repro_torch.models import build_model, init_flat
    from repro_torch.models.lm import RunFlags
    from repro_torch.serve.coldstart import cold_start
    from repro_torch.serve.engine import Request

    cfg = get_config("smollm-360m")
    if args.reduced:
        cfg = cfg.reduced()
    base = weights if weights is not None else init_flat(cfg, 0)
    backend = backend_for(args.device)
    out = {"fine_tunes": [], "replicas": []}
    snap0 = COUNTERS.snapshot()

    def delta(name: str) -> float:
        return COUNTERS.get(name) - snap0.get(name, 0)

    with contextlib.ExitStack() as stack:
        store = ChunkStore(args.store or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro-fleet-")))
        gc = GenerationalGC(store)
        publisher = ImageService(store, ServiceConfig(
            device=args.device, decode_backend=backend, l1_bytes=0,
            publish_warm_l1=False))
        stack.callback(publisher.close)
        print(f"== uploading {args.fine_tunes} fine-tunes (each touches "
              f"one tensor) ==")
        fts = fine_tunes(base, args.fine_tunes)
        blobs = []
        for i, (victim, ft) in enumerate(fts):
            blob, s = publisher.publish(
                ft, tenant=f"team{i}", tenant_key=tenant_key(i),
                root=gc.active, chunk_size=args.chunk_size,
                image_id=f"ft{i}")
            blobs.append(blob)
            out["fine_tunes"].append({
                "tensor": victim, "unique_chunks": s.unique_chunks,
                "dedup_chunks": s.dedup_chunks,
                "total_chunks": s.total_chunks,
                "unique_fraction": s.unique_fraction})
            print(f"   ft{i}: unique={s.unique_chunks:4d} "
                  f"dedup={s.dedup_chunks:4d} ({s.unique_fraction:5.1%} "
                  f"unique) {victim}")
        publisher.close()

        l2 = DistributedCache(num_nodes=6, seed=1,
                              flash_bytes=L2_FLASH_BYTES,
                              parity_fn=parity_fn_for_erasure(args.device),
                              matmul_fn=rs_matmul_fn(args.device),
                              hedge_quantile=DEFAULT_HEDGE_QUANTILE)
        # one shared service for the whole fleet: shared L1, the injected
        # L2, admission control, per-tenant telemetry scopes
        service = ImageService(store, ServiceConfig(
            device=args.device, decode_backend=backend,
            l1_bytes=args.l1_bytes, max_coldstarts=4,
            fetch_concurrency=16), l2=l2)
        stack.callback(service.close)
        victim_node = sorted(l2.nodes)[0]
        model = build_model(cfg, RunFlags(dtype=args.dtype),
                            device=args.device)
        print(f"== cold-starting {len(blobs)} replicas over ONE shared "
              f"ImageService (node {victim_node} failed after the "
              f"{FAIL_BEFORE}rd start) ==")
        for i, blob in enumerate(blobs):
            if i == FAIL_BEFORE:
                l2.fail_node(victim_node)   # erasure coding must hide this
            scoped = service.tenant_counters(f"team{i}")
            hits0 = scoped.get("read.l1_hits")
            eng, stats = cold_start(model, blob, tenant_key(i), service,
                                    max_batch=2, max_len=32)
            req = Request(0, prompt=list(PROMPT), max_new=MAX_NEW)
            eng.submit(req)
            eng.run_until_drained()
            rep = {"tenant": stats["tenant"],
                   "load_seconds": stats["load_seconds"],
                   "origin_fetches": stats["origin_fetches"],
                   "l1_hits": scoped.get("read.l1_hits") - hits0,
                   "l2_hits": stats["l2_hits"], "tokens": list(req.out)}
            out["replicas"].append(rep)
            print(f"   replica {i} [{rep['tenant']}]: "
                  f"load {rep['load_seconds'] * 1e3:6.0f}ms  "
                  f"origin_fetches={rep['origin_fetches']:4.0f}  "
                  f"cross-tenant L1 hits={rep['l1_hits']:5.0f}  "
                  f"L2 hits={rep['l2_hits']:4d}  tokens={rep['tokens']}")
            if on_replica is not None:
                on_replica(i, eng, stats, fts[i][1])
            del eng
        l2_reads = delta("l2.hits") + delta("l2.misses")
        out["fleet"] = {
            # the publisher probes the store before it uploads, so the
            # images' stats carry what the store's counters do in the
            # JAX example's serial create_image
            "chunks_uploaded": sum(s["unique_chunks"]
                                   for s in out["fine_tunes"]),
            "dedup_hits": sum(s["dedup_chunks"] for s in out["fine_tunes"]),
            "origin_fetches": sum(r["origin_fetches"]
                                  for r in out["replicas"]),
            "l1_hit_rate": service.l1.hit_rate,
            "l2_hit_rate": delta("l2.hits") / max(1.0, l2_reads),
            "l2_stripe_timeouts": delta("l2.stripe_timeouts"),
            "l2_hedges": delta("l2.hedges"),
            "failed_node": victim_node,
        }
        f = out["fleet"]
        print("== fleet stats ==")
        print(f"   chunks uploaded once: {f['chunks_uploaded']:.0f}; "
              f"dedup hits at creation: {f['dedup_hits']:.0f}; origin "
              f"fetches {f['origin_fetches']:.0f}")
        print(f"   shared L1 hit rate {f['l1_hit_rate']:.3f}; L2 hit rate "
              f"{f['l2_hit_rate']:.3f} with one node down (the shared L1 "
              f"absorbs the fleet once warm; L2 serves L1-evicted reads "
              f"4-of-5)")
    return out


if __name__ == "__main__":
    main()
