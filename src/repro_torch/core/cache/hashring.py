"""Consistent hashing with bounded loads (paper §4: a Karger ring with
virtual nodes and the Chen/Coleman/Shrivastava-style load-spreading
option), and the hot-key tracker behind the L2's salting. A copy of
``repro.core.cache.hashring``: both hash with ``hashlib``, so the same
node names give the same placement. The L2 looks up with
``bound_loads`` off, so the loads it records through
``record_placement`` never move its own placements."""
from __future__ import annotations

import bisect
import hashlib
import threading
from collections import defaultdict


def _h(s: str) -> int:
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


class HashRing:
    def __init__(self, nodes: list, vnodes: int = 64, load_factor: float = 1.25):
        self.vnodes = vnodes
        self.load_factor = load_factor
        self.loads = defaultdict(int)
        self._load_lock = threading.Lock()
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

    def remove_node(self, node: str):
        self._nodes.discard(node)
        self._ring = [(h, n) for h, n in self._ring if n != node]
        self.loads.pop(node, None)

    @property
    def nodes(self) -> list:
        return sorted(self._nodes)

    def _snapshot_loads(self) -> dict:
        # parallel fetch workers record placements concurrently; ONE
        # locked copy per lookup gives the whole scan (avg, cap, and
        # every per-node check) a consistent view instead of racing
        # record_placement's inserts mid-iteration
        with self._load_lock:
            return dict(self.loads)

    def lookup(self, key: str, count: int = 1, bound_loads: bool = False,
               allow_repeats: bool = True) -> list:
        """First `count` distinct nodes clockwise from hash(key); with
        bounded loads, overloaded nodes are skipped (next-fit). If fewer
        than `count` nodes exist and allow_repeats, wrap around (degraded
        stripe isolation beats unavailability)."""
        if not self._ring:
            raise RuntimeError("empty ring")
        loads = self._snapshot_loads() if bound_loads else {}
        avg = sum(loads.values()) / max(1, len(self._nodes))
        cap = self.load_factor * max(1.0, avg) + 1
        start = bisect.bisect_left(self._ring, (_h(key), ""))
        out, seen = [], set()
        i = start
        n_ring = len(self._ring)
        scanned = 0
        while len(out) < count and scanned < 2 * n_ring:
            _, node = self._ring[i % n_ring]
            i += 1
            scanned += 1
            if node in seen or node not in self._nodes:
                continue
            if bound_loads and len(out) == 0 \
                    and loads.get(node, 0) > cap \
                    and len(self._nodes) > count:
                continue
            seen.add(node)
            out.append(node)
        if len(out) < count:
            if allow_repeats and out:
                # cycle the distinct prefix of `out` itself (placement
                # order), so every distinct node recurs evenly; indexing
                # off any other collection risks repeating only a prefix
                distinct = len(out)
                while len(out) < count:
                    out.append(out[len(out) % distinct])
            else:
                raise RuntimeError(f"only {len(out)} nodes for count={count}")
        return out

    def record_placement(self, node: str, weight: int = 1):
        with self._load_lock:
            self.loads[node] += weight


class HotKeyTracker:
    """Per-key request-rate tracking for hot-chunk ("infected") salting
    (paper §4: chunks of very popular images overwhelm their placement
    nodes; the fix is to salt the hot key into multiple cache keys so
    reads spread over several replica sets).

    Counts are kept over a sliding window of the last ``window``
    requests (approximated by halving every count each time ``window``
    requests land — cheap exponential decay, no per-key timestamps), so
    a chunk that WAS hot last epoch cools off instead of staying
    infected forever. ``record(key)`` returns True once `key`'s
    windowed count crosses ``threshold``; ``threshold <= 0`` disables
    tracking entirely (zero overhead on the read path).
    Thread-safe: the stripe wave issues placements from pool threads."""

    def __init__(self, threshold: int, window: int = 4096):
        self.threshold = threshold
        self.window = max(1, int(window))
        self._counts: defaultdict[str, float] = defaultdict(float)
        self._since_decay = 0
        self._lock = threading.Lock()

    def record(self, key: str) -> bool:
        if self.threshold <= 0:
            return False
        with self._lock:
            self._counts[key] += 1
            self._since_decay += 1
            if self._since_decay >= self.window:
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

    def rate(self, key: str) -> float:
        with self._lock:
            return self._counts.get(key, 0.0)
