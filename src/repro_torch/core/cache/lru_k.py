"""LRU-k eviction (O'Neil et al., paper §4.3): evict by backward-K-distance
so one-shot scans (the cron-spike workload) can't flush the hot set."""
from __future__ import annotations

import heapq
import threading
from collections import deque


class LRUK:
    """Byte-capacity-bounded mapping with LRU-k eviction.

    Keys with fewer than k recorded accesses have backward-k-distance
    infinity and are evicted first (classic LRU-k policy), ordered by their
    most recent access among themselves.

    get/put/remove are thread-safe (one RLock): the batched read path
    backfills tiers from parallel fetch workers.
    """

    def __init__(self, capacity_bytes: int, k: int = 2):
        self.capacity = capacity_bytes
        self.k = k
        self.data: dict[str, bytes] = {}
        self.hist: dict[str, deque] = {}
        self.used = 0
        self.clock = 0
        self.evictions = 0
        self._lock = threading.RLock()

    def __contains__(self, key: str) -> bool:
        return key in self.data

    def _touch(self, key: str):
        self.clock += 1
        h = self.hist.setdefault(key, deque(maxlen=self.k))
        h.append(self.clock)

    def get(self, key: str):
        with self._lock:
            if key not in self.data:
                return None
            self._touch(key)
            return self.data[key]

    def peek(self, key: str):
        """``get`` without recording an access: a hedged re-GET of a key
        a node already served must not count twice toward its recency
        (one logical read, two requests)."""
        with self._lock:
            return self.data.get(key)

    def put(self, key: str, value: bytes):
        with self._lock:
            if key in self.data:
                self.used -= len(self.data[key])
            self.data[key] = value
            self.used += len(value)
            self._touch(key)
            self._evict()

    def _priority(self, key: str):
        h = self.hist.get(key)
        if h is None or len(h) < self.k:
            # infinite backward-k-distance: evict before any full-history key,
            # LRU among themselves
            return (0, h[-1] if h else 0)
        return (1, h[0])  # k-th most recent access time

    def _evict(self):
        if self.used <= self.capacity:
            return
        heap = [(*self._priority(k), k) for k in self.data]
        heapq.heapify(heap)
        while self.used > self.capacity and heap:
            *_, key = heapq.heappop(heap)
            if key in self.data:
                self.used -= len(self.data[key])
                del self.data[key]
                self.evictions += 1

    def remove(self, key: str):
        with self._lock:
            if key in self.data:
                self.used -= len(self.data[key])
                del self.data[key]

    def keys(self):
        return list(self.data)
