"""Consistent hashing (paper §4: a Karger ring with virtual nodes), and
the hot-key tracker behind the L2's salting. A copy of
``repro.core.cache.hashring`` without its bounded-load option, which the
L2 never turns on: both hash with ``hashlib``, so the same node names
give the same placement."""
from __future__ import annotations

import bisect
import hashlib
import threading
from collections import defaultdict


def _h(s: str) -> int:
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


class HashRing:
    def __init__(self, nodes: list, vnodes: int = 64):
        self.vnodes = vnodes
        self._nodes = set()
        self._ring: list[tuple[int, str]] = []
        for n in nodes:
            self.add_node(n)

    def add_node(self, node: str):
        if node in self._nodes:
            return
        self._nodes.add(node)
        for v in range(self.vnodes):
            self._ring.append((_h(f"{node}#{v}"), node))
        self._ring.sort()

    def lookup(self, key: str, count: int = 1) -> list:
        """First `count` distinct nodes clockwise from hash(key). If
        fewer than `count` nodes exist, wrap around (degraded stripe
        isolation beats unavailability)."""
        if not self._ring:
            raise RuntimeError("empty ring")
        start = bisect.bisect_left(self._ring, (_h(key), ""))
        out, seen = [], set()
        i = start
        n_ring = len(self._ring)
        scanned = 0
        while len(out) < count and scanned < 2 * n_ring:
            _, node = self._ring[i % n_ring]
            i += 1
            scanned += 1
            if node in seen:
                continue
            seen.add(node)
            out.append(node)
        # cycle the distinct prefix of `out` itself (placement order), so
        # every distinct node recurs evenly
        distinct = len(out)
        while len(out) < count:
            out.append(out[len(out) % distinct])
        return out


class HotKeyTracker:
    """Per-key request-rate tracking for hot-chunk ("infected") salting
    (paper §4: chunks of very popular images overwhelm their placement
    nodes; the fix is to salt the hot key into several cache keys so
    reads spread over several replica sets).

    Counts are kept over a sliding window of the last ``WINDOW``
    requests (approximated by halving every count each time ``WINDOW``
    requests land), so a chunk that WAS hot cools off. ``record(key)``
    returns True once `key`'s windowed count crosses ``threshold``;
    ``threshold <= 0`` disables tracking. Thread-safe: the stripe wave
    issues placements from pool threads."""

    WINDOW = 4096

    def __init__(self, threshold: int):
        self.threshold = threshold
        self._counts: defaultdict[str, float] = defaultdict(float)
        self._since_decay = 0
        self._lock = threading.Lock()

    def record(self, key: str) -> bool:
        if self.threshold <= 0:
            return False
        with self._lock:
            self._counts[key] += 1
            self._since_decay += 1
            if self._since_decay >= self.WINDOW:
                self._since_decay = 0
                cold = []
                for k in self._counts:
                    self._counts[k] /= 2
                    if self._counts[k] < 1.0:
                        cold.append(k)
                for k in cold:
                    del self._counts[k]
            return self._counts[key] >= self.threshold

    def is_hot(self, key: str) -> bool:
        if self.threshold <= 0:
            return False
        with self._lock:
            return self._counts.get(key, 0.0) >= self.threshold
