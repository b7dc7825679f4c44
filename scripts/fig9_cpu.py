#!/usr/bin/env python3
"""chip_smoke's phase 4b (the paper's Fig. 9) on the CPU, at the chunk
and stripe counts of SmolLM-360M's image with the bytes scaled down.

    PYTHONPATH=src python scripts/fig9_cpu.py [--chunks 2762] [--scale 8] [--seed 0]

A 12-node L2 (the phase-4 configuration, numpy erasure coding) is
filled with `--chunks` random chunks named by their SHA-256, as
content-addressed ciphertexts are, and ``chip_smoke.phase_fig9`` runs
on it: every name read through 4-of-5 and 4-of-4 on the healthy L2,
then with ``cache-000`` down. Chunk bytes and the node tiers are
divided by `--scale`, so the reads, stripe GETs and the memory tier's
evictions are the full run's while host memory stays small (~0.3 GB at
8). The simulated latencies do not depend on the bytes; the wall does,
by the hashing of each ciphertext (about 0.4 ms per 512 KiB). Prints
phase 4b's lines and its wall (~30 s at the defaults). The GF(256)
"launches" it prints are calls of the numpy matrix product.
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import time
import types
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.core.cache.distributed import DistributedCache  # noqa: E402
from repro_torch.core.erasure import gf_matmul  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=2762)
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    calls = types.SimpleNamespace(LAUNCHES={"gf256": 0})

    def matmul(m, d):
        calls.LAUNCHES["gf256"] += 1
        return gf_matmul(m, d)
    l2 = DistributedCache(num_nodes=12, seed=args.seed,
                          mem_bytes=(64 << 20) // args.scale,
                          flash_bytes=(512 << 20) // args.scale,
                          matmul_fn=matmul)
    size = (512 << 10) // args.scale
    rng = np.random.default_rng(args.seed)
    names = []
    t0 = time.perf_counter()
    for _ in range(args.chunks):
        ct = rng.integers(0, 256, size, np.uint8).tobytes()
        name = hashlib.sha256(ct).hexdigest()
        l2.put_chunk(name, ct)
        names.append(name)
    print(f"fill: {args.chunks} chunks of {size} bytes in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    chip_smoke.phase_fig9(calls, l2, sorted(names), size)
    print(f"phase 4b: {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
