#!/usr/bin/env python3
"""Host-side cost of the port's L2 (``DistributedCache``) at the chunk
count of SmolLM-360M's image, on the CPU, with numpy erasure coding.

    PYTHONPATH=src python scripts/profile_l2_host.py [--chunks 2762] [--scale 8]

A 12-node L2 (the chip_smoke phase-4 configuration) is filled with
`--chunks` chunks, one node crashes, and every chunk is read back in one
staged and one streamed hedged wave. The same run is made twice: with
the configured tiers (64 MiB memory over 512 MiB flash per node), where
the memory tier fills up and every further put into it (a write, or a
flash hit promoted on a read) runs LRU-K eviction, and with a memory
tier as large as the flash tier, where nothing is evicted. The
difference between the two is the eviction's cost. Also prints the
stripe bytes each node holds at full size. Chunk bytes and the node
tiers are divided by `--scale`, so the counts (puts, GETs, keys per
tier) are the full run's while host memory stays small.
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np

from repro_torch.core.cache.distributed import DistributedCache, FaultPlan

CHUNK = 512 << 10


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def run(datas: dict, size: int, seed: int, mem_bytes: int,
        flash_bytes: int) -> dict:
    l2 = DistributedCache(num_nodes=12, seed=seed, mem_bytes=mem_bytes,
                          flash_bytes=flash_bytes)
    names = list(datas)
    out = {"fill": timed(lambda: [l2.put_chunk(n, d)
                                  for n, d in datas.items()])}
    l2.set_fault("cache-000", FaultPlan.crashed())
    out["staged"] = timed(lambda: l2.get_chunks(names, size, hedge=True))
    out["streamed"] = timed(lambda: l2.get_chunks(
        names, size, hedge=True, on_ready=lambda *a: None))
    out["evictions"] = sum(node.mem.evictions for node in l2.nodes.values())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=2762)
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    size = CHUNK // args.scale
    datas = {rng.bytes(32).hex(): rng.integers(0, 256, size, np.uint8)
             .tobytes() for _ in range(args.chunks)}
    flash = (512 << 20) // args.scale
    ring = DistributedCache(num_nodes=12).ring
    load = collections.Counter(node for n in datas
                               for node in ring.lookup(n, count=5))
    mib = [v * CHUNK / 4 / 2**20 for v in load.values()]
    print(f"{args.chunks} chunks of 512 KiB on 12 nodes: "
          f"{min(mib):.1f}-{max(mib):.1f} MiB of stripes per node")
    for label, mem in (("configured tiers", (64 << 20) // args.scale),
                       ("no eviction", flash)):
        r = run(datas, size, args.seed, mem, flash)
        print(f"{label}: fill {r['fill']:.2f} s, staged wave "
              f"{r['staged']:.2f} s, streamed wave {r['streamed']:.2f} s, "
              f"{r['evictions']} memory-tier evictions")


if __name__ == "__main__":
    main()
