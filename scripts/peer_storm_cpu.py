#!/usr/bin/env python3
"""The peer tier's storm dynamics on the CPU, at a small size (no card).

    PYTHONPATH=src python scripts/peer_storm_cpu.py race [--trials 5]
    PYTHONPATH=src python scripts/peer_storm_cpu.py storm --crash leader

``race``: four threads behind a barrier each call ``probe_chunks`` on one
``PeerMesh`` for the same 2762 names (SmolLM-360M's distinct chunks),
in the same order, as the workers of a cold-start storm do. Prints how
many flights each worker leads, per trial.

``storm``: four ``ImageService`` workers (``device="cpu"``, numpy/hashlib
decode) restore one image of ``--chunks`` 4 KiB chunks through one mesh
over a ``FaultyStore`` whose GETs take ``--origin-delay-s`` (so the
leading worker resolves its flights over seconds, as the card's decode
backpressure paces it at full size). Once a worker has served
``--crash-after`` transfers it is crashed if it matches ``--crash``:
``leader`` (leads most flights), ``joiner`` (leads at most 1%) or
``none``. Prints one JSON line: fleet origin GETs against the distinct
chunks, deadline fall-throughs, join waits and the storm's wall, and
checks every restore against the published tree.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.cache.distributed import FaultPlan  # noqa: E402
from repro_torch.core.cache.peer import PeerMesh  # noqa: E402
from repro_torch.core.faults import FaultyStore, OriginFaultPlan  # noqa: E402
from repro_torch.core.service import ImageService, ServiceConfig, \
    build_peer_mesh  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.core.telemetry import COUNTERS  # noqa: E402

WORKERS = 4
NAMES = 2762
KEY = hashlib.sha256(b"peer storm").digest()


def race(trials: int) -> None:
    names = [f"{i:064x}" for i in range(NAMES)]
    for trial in range(trials):
        mesh = PeerMesh(WORKERS, seed=trial, deadline_s=0.01)
        barrier = threading.Barrier(WORKERS)
        leads = [None] * WORKERS

        def probe(i):
            c = mesh.client(i)
            barrier.wait(timeout=30)
            leads[i], _ = c.probe_chunks(names, 1, lambda *a: None)
        threads = [threading.Thread(target=probe, args=(i,))
                   for i in range(WORKERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for i, led in enumerate(leads):
            for name in led:            # release the joiners' waits
                mesh.client(i).put_chunk(name, b"x", source="origin")
        print(json.dumps({"trial": trial,
                          "leads": [len(x) for x in leads]}), flush=True)


def storm(args) -> dict:
    tmp = Path(tempfile.mkdtemp(prefix="peer-storm-"))
    store = ChunkStore(tmp)
    rng = np.random.default_rng(args.seed)
    tree = {"w": rng.standard_normal(args.chunks * 1024).astype(np.float32)}
    cfg = ServiceConfig(device="cpu", root="r0", decode_backend="python",
                        retry_attempts=5, retry_seed=args.seed,
                        peer_fanout=args.fanout,
                        peer_deadline_s=args.deadline_s)
    pub = ImageService(store, cfg)
    blob, st = pub.publish(tree, tenant="storm", tenant_key=KEY,
                           chunk_size=4096)
    pub.close()
    origin = FaultyStore(store, OriginFaultPlan.flaky(
        error_p=0.02, delay_s=args.origin_delay_s), seed=args.seed)
    led = [0] * WORKERS
    crash = {}
    lock = threading.Lock()

    def hook(name, src, dst):
        w = mesh.workers[src]
        if crash or args.crash == "none" or w.served < args.crash_after:
            return
        is_leader = led[src] == max(led)
        if is_leader != (args.crash == "leader") or \
                (not is_leader and led[src] > 0.01 * st.unique_chunks):
            return
        with lock:
            if not crash:
                crash.update(worker=src, served=w.served, led=led[src])
                mesh.set_fault(src, FaultPlan.crashed())
    mesh = build_peer_mesh(cfg, WORKERS, seed=args.seed, transfer_hook=hook)
    waits = []

    def instrument(client):
        probe, join_wait = client.probe_chunks, client._join_wait

        def counted(names, chunk_len, on_ready):
            leads, futs = probe(names, chunk_len, on_ready)
            led[client.wid] += len(leads)
            return leads, futs

        def timed(name, flight):
            t0 = time.perf_counter()
            try:
                return join_wait(name, flight)
            finally:
                with lock:
                    waits.append(time.perf_counter() - t0)
        client.probe_chunks, client._join_wait = counted, timed
        return client
    svcs = [ImageService(origin, cfg, peer=instrument(mesh.client(i)))
            for i in range(WORKERS)]
    barrier = threading.Barrier(WORKERS)
    out, errors = {}, []

    def work(i):
        try:
            barrier.wait(timeout=60)
            out[i] = svcs[i].open(blob, KEY).restore_tree()
        except Exception as e:          # reported below
            errors.append(repr(e))
    c0 = COUNTERS.snapshot()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(WORKERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=args.timeout_s)
    wall = time.perf_counter() - t0
    names = ("read.origin_fetches", "peer.deadline_fallthroughs",
             "peer.dead_peer_fallthroughs", "peer.tree_repairs",
             "peer.transfers", "read.peer_fallthroughs", "retry.retries")
    d = {k: COUNTERS.get(k) - c0.get(k, 0.0) for k in names}
    res = {
        "chunks": st.unique_chunks, "crash": crash, "led": led,
        "origin_gets": d.pop("read.origin_fetches"),
        "origin_per_unique": None, **d,
        "joins": len(waits), "join_wait_max_s": max(waits, default=0.0),
        "joins_at_deadline": sum(w >= args.deadline_s for w in waits),
        "storm_wall_s": wall,
        "finished": sum(not t.is_alive() for t in threads),
        "byte_identical": all(out[i]["w"].tobytes() == tree["w"].tobytes()
                              for i in out),
        "errors": errors,
    }
    res["origin_per_unique"] = res["origin_gets"] / st.unique_chunks
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("race")
    r.add_argument("--trials", type=int, default=5)
    s = sub.add_parser("storm")
    s.add_argument("--crash", choices=("leader", "joiner", "none"),
                   default="leader")
    s.add_argument("--crash-after", type=int, default=5)
    s.add_argument("--chunks", type=int, default=120)
    s.add_argument("--origin-delay-s", type=float, default=0.1)
    s.add_argument("--fanout", type=int, default=4)
    s.add_argument("--deadline-s", type=float, default=2.0)
    s.add_argument("--timeout-s", type=float, default=600.0)
    s.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.cmd == "race":
        race(args.trials)
        return 0
    print(json.dumps(storm(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
