"""L1: per-worker chunk cache (paper Fig 4 'local cache')."""
from __future__ import annotations

from repro_torch.core.cache.lru_k import LRUK
from repro_torch.core.telemetry import COUNTERS


class LocalCache:
    def __init__(self, capacity_bytes: int = 256 * 1024 * 1024, k: int = 2,
                 name: str = "l1"):
        self.name = name
        self.lru = LRUK(capacity_bytes, k=k)

    def get(self, key: str):
        v = self.lru.get(key)
        COUNTERS.inc(f"{self.name}.hits" if v is not None else f"{self.name}.misses")
        return v

    def peek(self, key: str):
        """`get` without touching hit/miss telemetry (used by the reader's
        single-flight double-check so stampedes don't distort hit rates)."""
        return self.lru.get(key)

    def put(self, key: str, value: bytes):
        self.lru.put(key, value)

    def invalidate(self, key: str):
        """Drop `key` (the reader evicts tamper-flagged ciphertexts so a
        retry refetches instead of replaying the bad bytes)."""
        self.lru.remove(key)

    def __contains__(self, key):
        return key in self.lru

    @property
    def hit_rate(self) -> float:
        h = COUNTERS.get(f"{self.name}.hits")
        m = COUNTERS.get(f"{self.name}.misses")
        return h / max(1.0, h + m)
