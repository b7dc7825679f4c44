"""Counters and latency recorders (copy of ``repro.core.telemetry``:
the port keeps its own so it never imports the JAX package)."""
from __future__ import annotations

import threading
from collections import defaultdict, deque

import numpy as np


class Counters:
    """Process-wide counters. Every mutator AND reader takes the lock:
    fetch pool threads, decoder pool threads, and streaming producer
    threads all update concurrently, and the totals must stay exact
    (tested by hammering from 8 threads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c = defaultdict(float)

    def inc(self, name: str, n: float = 1):
        with self._lock:
            self._c[name] += n

    add = inc

    def max_update(self, name: str, value: float):
        """Monotonic high-water mark (e.g. the streaming hand-off
        queue's max depth)."""
        with self._lock:
            if value > self._c[name]:
                self._c[name] = value

    def get(self, name: str) -> float:
        with self._lock:
            return self._c.get(name, 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)

    def reset(self):
        with self._lock:
            self._c.clear()

    def scope(self, tag: str) -> "ScopedCounters":
        """A tenant/session-scoped view: updates through it land in BOTH
        the global name and ``<tag>::<name>``, so shared-infrastructure
        totals stay intact while per-tenant activity stays attributable
        (the Fig-5 cross-customer dedup story needs both)."""
        return ScopedCounters(self, tag)


class ScopedCounters:
    """Scoped view over a base ``Counters`` (see ``Counters.scope``).

    Mutators mirror every update into the scoped namespace; readers
    (``get`` / ``snapshot``) answer from the scoped namespace only.
    Drop-in for the reader's ``counters`` hook: same inc/add/max_update/
    get surface, same lock discipline (the base's)."""

    __slots__ = ("_base", "tag")
    SEP = "::"

    def __init__(self, base: Counters, tag: str):
        self._base = base
        self.tag = tag

    def _key(self, name: str) -> str:
        return f"{self.tag}{self.SEP}{name}"

    def inc(self, name: str, n: float = 1):
        self._base.inc(name, n)
        self._base.inc(self._key(name), n)

    add = inc

    def max_update(self, name: str, value: float):
        self._base.max_update(name, value)
        self._base.max_update(self._key(name), value)

    def get(self, name: str) -> float:
        """Scoped value (use the base ``Counters`` for the global one)."""
        return self._base.get(self._key(name))

    def snapshot(self) -> dict:
        pre = f"{self.tag}{self.SEP}"
        return {k[len(pre):]: v for k, v in self._base.snapshot().items()
                if k.startswith(pre)}


COUNTERS = Counters()


class LatencyRecorder:
    """Collects latency samples; emits percentiles and eCDFs (the paper
    reports eCDFs because summary stats hide multi-modality, §5.1)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.samples: list[float] = []
        self._lock = threading.Lock()

    def record(self, seconds: float):
        # parallel fetch workers record concurrently
        with self._lock:
            self.samples.append(seconds)

    def _snapshot(self) -> np.ndarray:
        # readers run concurrently with recording threads; snapshot under
        # the lock so np.array never sees a list mid-append
        with self._lock:
            return np.array(self.samples, dtype=float)

    def percentile(self, p: float) -> float:
        a = self._snapshot()
        if not len(a):
            return float("nan")
        return float(np.percentile(a, p))

    def ecdf(self, points: int = 200):
        xs = np.sort(self._snapshot())
        ys = np.arange(1, len(xs) + 1) / len(xs)
        if len(xs) > points:
            idx = np.linspace(0, len(xs) - 1, points).astype(int)
            xs, ys = xs[idx], ys[idx]
        return xs.tolist(), ys.tolist()

    def summary(self) -> dict:
        a = self._snapshot()
        if not len(a):
            return {"n": 0}
        return {"n": len(a), "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)),
                "p999": float(np.percentile(a, 99.9)),
                "max": float(a.max())}



class ErrorRateWindow:
    """Sliding success/failure window: the circuit breaker's error-rate
    input (``core.retry.CircuitBreaker``), so an old outage does not
    keep the breaker twitchy after the origin healed. Thread-safe."""

    def __init__(self, maxlen: int = 64):
        self._dq: deque = deque(maxlen=max(1, int(maxlen)))
        self._lock = threading.Lock()

    def record(self, ok: bool):
        with self._lock:
            self._dq.append(0 if ok else 1)

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def error_rate(self) -> float:
        with self._lock:
            if not self._dq:
                return 0.0
            return sum(self._dq) / len(self._dq)

    def reset(self):
        """Drop history (a breaker transition starts a fresh regime)."""
        with self._lock:
            self._dq.clear()

class QuantileWindow:
    """Sliding-window quantile over the most recent samples: the L2's
    hedged-GET deadline is "past the p-th quantile of *recent* stripe
    latencies", so the window is a small ring buffer. ``quantile``
    returns NaN until ``min_samples`` have landed (hedging stays off
    while the estimate would be noise). Thread-safe: stripe pool workers
    record concurrently."""

    def __init__(self, maxlen: int = 512, min_samples: int = 32):
        self._dq: deque = deque(maxlen=maxlen)
        self.min_samples = min_samples
        self._lock = threading.Lock()

    def record(self, value: float):
        with self._lock:
            self._dq.append(value)

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def quantile(self, q: float) -> float:
        with self._lock:
            if len(self._dq) < self.min_samples:
                return float("nan")
            a = np.fromiter(self._dq, dtype=float)
        return float(np.quantile(a, q))
