"""Production-style serving launcher: cold-start a replica from a chunk
store manifest and serve a batch of synthetic requests (the port of
``repro.launch.serve``).

The flags build ONE ``ServiceConfig`` and one ``ReadPolicy``; everything
the read path shares (L1/L2 tiers, admission control, origin-fetch
concurrency, the decode pool) is owned by a single ``ImageService``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      [--no-reduced] [--store DIR --image IMAGE_ID [--root R]] \\
      [--requests 8] [--device cuda|cpu]
If no --store is given, a model is initialized from seed 0, imaged into
a temporary store (removed at exit), and then cold-started from it.

Every flag of the JAX package's launcher is here under the same name
and default, except:

* ``--decode-backend`` defaults to ``torch-fused``, the port's card
  backend (the JAX launcher's default is ``numpy``);
* ``--device`` (default ``cuda``) is added: the service's and the
  model's device, ``cpu`` for the plain PyTorch versions;
* ``--jax-compile-cache`` is not carried over: it configures JAX's
  compiler;
* ``--reduced`` is ``--reduced/--no-reduced`` (default reduced): the
  JAX launcher's ``store_true`` with ``default=True`` can never be
  turned off, so it can serve neither a full-width model nor an image
  published at full width.

As in the JAX package, the engine prefills prompts by decoding them one
token a step. ``main(argv)`` prints the JAX launcher's lines and returns
a dict of the cold start's stats, the served tokens and the decode tile.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

from repro_torch.configs import get_config
from repro_torch.core.decode import known_backend_names
from repro_torch.core.gc import GenerationalGC
from repro_torch.core.loader import create_image
from repro_torch.core.service import ImageService, ReadPolicy, ServiceConfig
from repro_torch.core.store import ChunkStore
from repro_torch.models import build_model, init_flat
from repro_torch.serve.coldstart import cold_start
from repro_torch.serve.engine import Request

TENANT_KEY = b"S" * 32
PUBLISH_CHUNK_SIZE = 65536


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--store", default=None)
    ap.add_argument("--image", default=None)
    ap.add_argument("--root", default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the config's reduced() widths "
                         "(--no-reduced: the full-width model)")
    ap.add_argument("--device", default="cuda",
                    help="the service's and the model's device; cpu runs "
                         "the kernels' plain PyTorch versions")
    ap.add_argument("--l1-bytes", type=int, default=256 << 20,
                    help="shared worker-local L1 cache size (0 = no L1)")
    ap.add_argument("--l2-nodes", type=int, default=6,
                    help="erasure-coded L2 cluster size (0 = no L2)")
    ap.add_argument("--l2-stripe-deadline-ms", type=float, default=None,
                    help="per-stripe GET deadline in ms (default: the "
                         "cache's built-in deadline)")
    ap.add_argument("--l2-hedge-quantile", type=float, default=None,
                    help="hedged stripe GETs past this quantile of recent "
                         "stripe latencies, e.g. 0.95 (default: off)")
    ap.add_argument("--l2-infection-threshold", type=int, default=0,
                    help="hot-key salting: windowed per-chunk request "
                         "count past which a chunk is salted (0 = off)")
    ap.add_argument("--l2-salt-count", type=int, default=3,
                    help="placement keys an infected chunk is salted into")
    ap.add_argument("--peer-workers", type=int, default=0,
                    help="peer mesh size: simulate this many workers "
                         "sharing a peer tier and join it as worker 0 "
                         "(0 = no peer tier)")
    ap.add_argument("--peer-fanout", type=int, default=4,
                    help="provisioning-tree arity")
    ap.add_argument("--peer-registration", default="all",
                    choices=["all", "origin"],
                    help="which workers advertise chunks in the peer "
                         "directory")
    ap.add_argument("--peer-deadline-ms", type=float, default=2000.0,
                    help="bounded wait on a joined peer flight before "
                         "falling through to L2/origin")
    ap.add_argument("--peer-fault", default=None, metavar="WID:KIND",
                    help="peer fault injection, e.g. 3:crashed or "
                         "1:blackholed")
    ap.add_argument("--max-coldstarts", type=int, default=4,
                    help="admission control: concurrent cold starts "
                         "accepted before rejecting (paper §4.2)")
    ap.add_argument("--fetch-concurrency", type=int, default=16,
                    help="bound on concurrent origin chunk fetches across "
                         "all restores; 0 = unbounded")
    ap.add_argument("--parallelism", type=int, default=8,
                    help="per-restore fetch pipeline width")
    ap.add_argument("--decode-backend", default="torch-fused",
                    choices=known_backend_names(),
                    help="decode backend from the core.decode registry: "
                         "torch-fused/fused = ONE fused verify+decrypt "
                         "kernel per tile; torch = SHA-256 then AES "
                         "kernels; python/numpy = T-table numpy + "
                         "hashlib; auto = torch-fused; serial = per-chunk "
                         "oracle")
    ap.add_argument("--max-batch-bytes", type=int, default=None,
                    help="decode tile size in bytes (default: per-backend "
                         "autotuned at first use, cached per process; a "
                         "value here pins the tile and skips the sweep)")
    ap.add_argument("--eager-min-bytes", type=int, default=None,
                    help="minimum partial-tile bytes before an eager "
                         "flush may fire (default: ServiceConfig's)")
    ap.add_argument("--read-path", default="streamed",
                    choices=["streamed", "staged", "serial"],
                    help="ReadPolicy.mode")
    ap.add_argument("--publish", action="store_true",
                    help="image the model through the service's batched "
                         "write path instead of the serial create_image")
    ap.add_argument("--upload-parallelism", type=int, default=8,
                    help="bounded-parallel PUTs on the publish path")
    ap.add_argument("--eager-flush", action="store_true",
                    help="decode the partial tile whenever the streamed "
                         "consumer would otherwise block")
    ap.add_argument("--retry-attempts", type=int, default=0,
                    help="origin attempts per GET/PUT (0/1 = retries off)")
    ap.add_argument("--retry-base-ms", type=float, default=10.0,
                    help="backoff floor per retry")
    ap.add_argument("--retry-cap-ms", type=float, default=500.0,
                    help="backoff ceiling per retry")
    ap.add_argument("--retry-budget-ms", type=float, default=None,
                    help="wall budget across one call's retries")
    ap.add_argument("--retry-attempt-timeout-ms", type=float, default=None,
                    help="per-attempt origin deadline")
    ap.add_argument("--breaker-threshold", type=float, default=None,
                    help="origin error rate that opens the circuit "
                         "breaker, e.g. 0.5 (default: off)")
    ap.add_argument("--breaker-window", type=int, default=64,
                    help="breaker sliding window size")
    ap.add_argument("--breaker-min-samples", type=int, default=10,
                    help="outcomes in the window before the breaker may "
                         "trip")
    ap.add_argument("--breaker-cooldown-ms", type=float, default=1000.0,
                    help="open -> half-open cooldown")
    ap.add_argument("--breaker-half-open-probes", type=int, default=1,
                    help="concurrent origin probes allowed half-open")
    ap.add_argument("--no-breaker-shed", action="store_true",
                    help="keep admitting cold starts while the breaker "
                         "is open")
    ap.add_argument("--origin-fault", default=None, metavar="SPEC",
                    help="origin fault injection (FaultyStore): "
                         "'unavailable', or comma k=v pairs of "
                         "error_p/corrupt_p/delay_ms")
    ap.add_argument("--publish-name-index", default=None, metavar="PATH",
                    help="persist the publish path's plaintext-hash -> "
                         "chunk-name index to this sidecar file")
    return ap


def origin_fault_plan(spec: str):
    """The ``OriginFaultPlan`` of an ``--origin-fault`` spec."""
    from repro_torch.core.faults import OriginFaultPlan
    if spec.strip() == "unavailable":
        return OriginFaultPlan.unavailable()
    kv = dict(p.split("=", 1) for p in spec.split(",") if p)
    return OriginFaultPlan.flaky(
        error_p=float(kv.get("error_p", 0.0)),
        corrupt_p=float(kv.get("corrupt_p", 0.0)),
        delay_s=float(kv.get("delay_ms", 0.0)) / 1e3)


def _ms(v):
    return v / 1e3 if v is not None else None


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    model = build_model(cfg, device=args.device)

    pending_tree = None
    tmp = None
    if args.store and args.image:
        store = ChunkStore(args.store)
        root = args.root or "R1"
        blob = store.get_manifest(root, args.image)
    else:
        tmp = tempfile.mkdtemp(prefix="repro-serve-")
        store = ChunkStore(tmp)
        root = GenerationalGC(store).active
        tree = init_flat(cfg, 0)
        if args.publish:
            # imaged below, through the service's batched write path:
            # the fresh ciphertexts then warm the L1 the cold start hits
            pending_tree, blob = tree, None
        else:
            blob, stats = create_image(tree, tenant="serve",
                                       tenant_key=TENANT_KEY,
                                       store=store, root=root,
                                       chunk_size=PUBLISH_CHUNK_SIZE)
            print(f"imaged {stats.total_chunks} chunks "
                  f"({stats.bytes_total/1e6:.1f} MB)")
    try:
        return _serve(args, model, store, root, blob, pending_tree)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _serve(args, model, store, root: str, blob, pending_tree) -> dict:
    # ONE config object owns every shared read-path knob: cache tiers,
    # admission control (reject excess cold starts) and fetch
    # concurrency (block excess origin reads) are separate bounds (§4.2)
    policy = ReadPolicy(mode=args.read_path, parallelism=args.parallelism,
                        eager_flush=args.eager_flush,
                        eager_min_bytes=args.eager_min_bytes)
    svc_cfg = ServiceConfig(
        l1_bytes=args.l1_bytes,
        l2_nodes=args.l2_nodes,
        l2_stripe_deadline_s=_ms(args.l2_stripe_deadline_ms),
        l2_hedge_quantile=args.l2_hedge_quantile,
        l2_infection_threshold=args.l2_infection_threshold,
        l2_salt_count=args.l2_salt_count,
        max_coldstarts=args.max_coldstarts,
        fetch_concurrency=args.fetch_concurrency,
        decode_backend=args.decode_backend,
        peer_fanout=args.peer_fanout,
        peer_deadline_s=args.peer_deadline_ms / 1e3,
        peer_registration=args.peer_registration,
        root=root,
        upload_parallelism=args.upload_parallelism,
        default_policy=policy,
        retry_attempts=args.retry_attempts,
        retry_base_s=args.retry_base_ms / 1e3,
        retry_cap_s=args.retry_cap_ms / 1e3,
        retry_total_budget_s=_ms(args.retry_budget_ms),
        retry_attempt_timeout_s=_ms(args.retry_attempt_timeout_ms),
        breaker_threshold=args.breaker_threshold,
        breaker_window=args.breaker_window,
        breaker_min_samples=args.breaker_min_samples,
        breaker_cooldown_s=args.breaker_cooldown_ms / 1e3,
        breaker_half_open_probes=args.breaker_half_open_probes,
        breaker_shed_coldstarts=not args.no_breaker_shed,
        publish_name_index_path=args.publish_name_index,
        device=args.device,
    )
    if args.origin_fault:
        from repro_torch.core.faults import FaultyStore
        plan = origin_fault_plan(args.origin_fault)
        store = FaultyStore(store, plan)
        print(f"origin fault injection: {plan}")
    if args.max_batch_bytes is not None:
        svc_cfg.max_batch_bytes = args.max_batch_bytes
    if args.eager_min_bytes is not None:
        svc_cfg.eager_min_bytes = args.eager_min_bytes
    peer = None
    if args.peer_workers > 0:
        from repro_torch.core.service import build_peer_mesh
        mesh = build_peer_mesh(svc_cfg, args.peer_workers)
        if args.peer_fault:
            from repro_torch.core.cache.distributed import FaultPlan
            wid, kind = args.peer_fault.split(":", 1)
            mesh.set_fault(int(wid), getattr(FaultPlan, kind)())
        peer = mesh.client(0)
        print(f"peer mesh: {args.peer_workers} workers, fanout "
              f"{args.peer_fanout}, registration {args.peer_registration}"
              f"{', fault ' + args.peer_fault if args.peer_fault else ''}")
    service = ImageService(store, svc_cfg, peer=peer)
    if pending_tree is not None:
        t0 = time.time()
        blob, stats = service.publish(pending_tree, tenant="serve",
                                      tenant_key=TENANT_KEY,
                                      chunk_size=PUBLISH_CHUNK_SIZE)
        print(f"published {stats.total_chunks} chunks "
              f"({stats.bytes_total/1e6:.1f} MB) in {time.time()-t0:.2f}s "
              f"[batched pipeline, {stats.unique_chunks} uploaded, "
              f"{stats.dedup_chunks} dedup'd]")
    t0 = time.time()
    engine, stats = cold_start(model, blob, TENANT_KEY, service, policy=policy,
                               max_batch=4, max_len=64)
    pipe = ""
    if stats.get("fetch_wall_s") is not None:   # serial mode has no split
        pipe = (f", fetch {stats['fetch_wall_s']:.2f}s + "
                f"decode[{stats['decode_backend']}] "
                f"{stats['decode_wall_s']:.2f}s")
    if stats.get("streamed"):
        pipe += (f", {stats['overlap_s']:.2f}s decode hidden under fetch "
                 f"(queue hwm {stats['queue_hwm']}"
                 f"{', eager flushes %d' % stats['eager_flushes'] if args.eager_flush else ''})")
    print(f"cold start {time.time()-t0:.2f}s [{args.read_path}] "
          f"(load {stats['load_seconds']:.2f}s, tenant {stats['tenant']}, "
          f"origin fetches {stats['origin_fetches']:.0f}{pipe})")

    reqs = [Request(i, prompt=[1 + i, 2, 3], max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        engine.submit(r)
    run = engine.run_until_drained()
    done = sum(r.done for r in reqs)
    print(f"served {done}/{len(reqs)} requests in {run['steps']} decode steps "
          f"({run['seconds']:.2f}s)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out}")
    tile = service.decoder_for(policy).max_batch_bytes
    service.close()        # drain decoder pools + session caches
    return {"cold_start": stats, "tokens": [r.out for r in reqs],
            "served": done, "requests": len(reqs), "steps": run["steps"],
            "serve_seconds": run["seconds"], "tile_bytes": tile,
            "config": model.cfg.name}


if __name__ == "__main__":
    main()
