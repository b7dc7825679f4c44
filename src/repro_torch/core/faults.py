"""Pluggable origin fault layer (copy of ``repro.core.faults``): a
``FaultPlan``-style wrapper over the ``ChunkStore``, mirroring the L2's
per-node plans (``cache.distributed.FaultPlan``) for the ORIGIN tier.

``FaultyStore`` wraps any chunk-store-shaped object and injects, per
the active ``OriginFaultPlan``:

* **transient errors** — ``get_chunk``/``put_if_absent`` raise
  ``TransientStoreError`` with probability ``error_p`` (an S3 500/503);
* **corrupt bytes** — ``get_chunk`` returns the real ciphertext with
  one byte flipped, with probability ``corrupt_p``. Convergent
  encryption's integrity check (``IntegrityError``) is the detection
  path; the reader evicts + refetches;
* **slow reads** — a fixed ``delay_s`` per call. When the caller passes
  a per-attempt ``deadline_s`` (the ``RetryPolicy`` does), a delay past
  the deadline costs only the deadline and raises
  ``StoreTimeoutError``;
* **unavailability windows** — the ``UNAVAILABLE`` kind fails every
  call; plans are switchable mid-flight via ``set_fault``.

Deterministic helpers ``fail_next(n)`` / ``corrupt_next(n)`` queue
exactly-n injected outcomes regardless of probabilities. The RNG is
seeded (``random.Random(seed)``, as in the reference), so a seeded run
injects the same faults in both packages.

Every other attribute (``put_manifest``, ...) forwards to the wrapped
store untouched: with the default HEALTHY plan the wrapper is
transparent.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

from repro_torch.core.telemetry import COUNTERS


class TransientStoreError(Exception):
    """A retryable origin failure (throttle/5xx analogue)."""

    retryable = True


class StoreUnavailableError(TransientStoreError):
    """The origin is inside an unavailability window."""


class StoreTimeoutError(TransientStoreError):
    """An attempt exceeded its per-attempt deadline."""


@dataclass(frozen=True)
class OriginFaultPlan:
    """How the wrapped origin answers (frozen, kind-tagged, switchable
    mid-flight via ``FaultyStore.set_fault``)."""

    HEALTHY = "healthy"
    FLAKY = "flaky"
    SLOW = "slow"
    UNAVAILABLE = "unavailable"

    kind: str = HEALTHY
    error_p: float = 0.0        # transient-error probability per call
    corrupt_p: float = 0.0      # corrupt-read probability per get
    delay_s: float = 0.0        # injected service delay per call

    @classmethod
    def healthy(cls) -> "OriginFaultPlan":
        return cls(cls.HEALTHY)

    @classmethod
    def flaky(cls, error_p: float = 0.1, corrupt_p: float = 0.0,
              delay_s: float = 0.0) -> "OriginFaultPlan":
        return cls(cls.FLAKY, error_p=error_p, corrupt_p=corrupt_p,
                   delay_s=delay_s)

    @classmethod
    def slow(cls, delay_s: float) -> "OriginFaultPlan":
        return cls(cls.SLOW, delay_s=delay_s)

    @classmethod
    def unavailable(cls) -> "OriginFaultPlan":
        return cls(cls.UNAVAILABLE)


class FaultyStore:
    """Fault-injecting wrapper over a ``ChunkStore``-shaped object.

    Faults apply to the chunk data plane — ``get_chunk`` and
    ``put_if_absent`` — where the retry policy is threaded; manifests
    forward untouched. ``get_chunk`` accepts an optional ``deadline_s``
    (the reader forwards the retry policy's per-attempt deadline)."""

    def __init__(self, inner, plan: OriginFaultPlan | None = None,
                 *, seed: int = 0, counters=None):
        self.inner = inner
        self.plan = plan if plan is not None else OriginFaultPlan.healthy()
        self.counters = counters if counters is not None else COUNTERS
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._fail_queue = 0
        self._corrupt_queue = 0

    # ------------------------------------------------------------- plans
    def set_fault(self, plan: OriginFaultPlan):
        """Switch the plan mid-flight (in-flight calls keep the plan
        they read)."""
        self.plan = plan

    def fail_next(self, n: int = 1):
        """Fail the next `n` faultable calls with a
        ``TransientStoreError`` (regardless of the plan's ``error_p``)."""
        with self._lock:
            self._fail_queue += n

    def corrupt_next(self, n: int = 1):
        """Corrupt the next `n` ``get_chunk`` payloads."""
        with self._lock:
            self._corrupt_queue += n

    # ---------------------------------------------------------- plumbing
    def __getattr__(self, item):
        return getattr(self.inner, item)

    def _draw_fail(self, plan: OriginFaultPlan) -> bool:
        with self._lock:
            if self._fail_queue > 0:
                self._fail_queue -= 1
                return True
            return plan.error_p > 0 and self._rng.random() < plan.error_p

    def _draw_corrupt(self, plan: OriginFaultPlan) -> bool:
        with self._lock:
            if self._corrupt_queue > 0:
                self._corrupt_queue -= 1
                return True
            return plan.corrupt_p > 0 and \
                self._rng.random() < plan.corrupt_p

    def _inject(self, plan: OriginFaultPlan, op: str,
                deadline_s: float | None):
        """Common pre-payload faults: outage, transient error, delay."""
        if plan.kind == OriginFaultPlan.UNAVAILABLE:
            self.counters.inc("faults.origin_unavailable")
            raise StoreUnavailableError(f"origin unavailable ({op})")
        if self._draw_fail(plan):
            self.counters.inc("faults.origin_transient")
            raise TransientStoreError(f"injected transient origin "
                                      f"error ({op})")
        if plan.delay_s > 0:
            if deadline_s is not None and plan.delay_s > deadline_s:
                time.sleep(deadline_s)
                self.counters.inc("faults.origin_timeouts")
                raise StoreTimeoutError(
                    f"origin {op} exceeded per-attempt deadline "
                    f"{deadline_s:.3f}s")
            time.sleep(plan.delay_s)
            self.counters.add("faults.origin_slow_s", plan.delay_s)

    # --------------------------------------------------------- data plane
    def get_chunk(self, root: str, name: str,
                  deadline_s: float | None = None) -> bytes:
        plan = self.plan
        self._inject(plan, "get", deadline_s)
        data = self.inner.get_chunk(root, name)
        if self._draw_corrupt(plan) and data:
            with self._lock:
                pos = self._rng.randrange(len(data))
            data = data[:pos] + bytes([data[pos] ^ 0xFF]) + data[pos + 1:]
            self.counters.inc("faults.origin_corrupt")
        return data

    def put_if_absent(self, root: str, name: str, data: bytes) -> bool:
        self._inject(self.plan, "put", None)
        return self.inner.put_if_absent(root, name, data)
