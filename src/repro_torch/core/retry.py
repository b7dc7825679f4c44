"""Origin-tier retry policy + circuit breaker (copy of
``repro.core.retry``).

* ``RetryPolicy`` — bounded retries with exponential backoff and
  decorrelated jitter (``sleep = min(cap, uniform(base, prev * 3))``,
  drawn from ``random.Random(seed)`` as in the reference, so a seeded
  policy draws the same backoffs in both packages), an optional
  per-attempt deadline (forwarded to deadline-capable stores) and an
  optional total wall budget across attempts. ``attempts <= 1`` is the
  zero-budget policy: exactly one call, no sleeps.
* ``CircuitBreaker`` — error-rate driven brownout ladder over the
  origin: ``closed`` (failures recorded into a sliding
  ``ErrorRateWindow``) → ``open`` (every ``allow()`` is shed for
  ``cooldown_s``; cold starts are shed with a retry-after) →
  ``half_open`` (at most ``half_open_probes`` concurrent probes; one
  success closes, one failure re-opens). ``BreakerOpenError`` carries
  ``retry_after_s`` so the retry layer backs off for the remaining
  cooldown.

Only transient failures count: ``faults.TransientStoreError``, stdlib
``TimeoutError``/``ConnectionError``, or an exception with
``retryable = True``. A ``FileNotFoundError`` (missing chunk) is not
retried.

Counters: ``retry.attempts`` / ``retries`` / ``backoff_s`` /
``giveups`` / ``budget_exhausted``; ``breaker.opened`` / ``half_opens``
/ ``probes`` / ``closed`` / ``shed``.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.faults import TransientStoreError
from repro_torch.core.telemetry import COUNTERS, ErrorRateWindow


class BreakerOpenError(TransientStoreError):
    """The origin circuit breaker shed this request. Retryable: the
    backoff honors ``retry_after_s`` (the remaining cooldown)."""

    def __init__(self, retry_after_s: float = 0.0):
        super().__init__(f"origin breaker open "
                         f"(retry after {retry_after_s:.3f}s)")
        self.retry_after_s = retry_after_s


def is_retryable(exc: BaseException) -> bool:
    """Transient (worth another attempt) vs deterministic failures."""
    if isinstance(exc, TransientStoreError):
        return True
    if isinstance(exc, FileNotFoundError):        # missing chunk: a bug,
        return False                              # not weather
    if isinstance(exc, (TimeoutError, ConnectionError)):
        return True
    return bool(getattr(exc, "retryable", False))


@dataclass
class RetryPolicy:
    """Bounded retries with decorrelated-jitter backoff.

    ``attempts`` is the TOTAL attempt count (1 = the zero-budget
    policy; ``call`` is then exactly ``fn()``). ``attempt_timeout_s`` is
    forwarded to deadline-capable stores; ``total_budget_s`` bounds the
    wall clock across attempts including sleeps (the next sleep is
    refused when it would bust the budget). ``integrity_refetches``
    bounds the reader's evict+refetch rounds after an
    ``IntegrityError``. A ``seed`` pins the jitter stream."""

    attempts: int = 3
    base_s: float = 0.01
    cap_s: float = 0.5
    total_budget_s: float | None = None
    attempt_timeout_s: float | None = None
    integrity_refetches: int = 2
    seed: int | None = None
    _rng: random.Random = field(init=False, repr=False, compare=False,
                                default=None)

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def next_backoff(self, prev_s: float) -> float:
        """Decorrelated jitter: ``min(cap, uniform(base, prev * 3))``."""
        hi = max(self.base_s, prev_s * 3.0)
        return min(self.cap_s, self._rng.uniform(self.base_s, hi))

    def call(self, fn, *, counters=None, retryable=None, sleep=time.sleep):
        """Run ``fn()`` under this policy. Retries only transient
        failures; an exception's ``retry_after_s`` floors the sleep."""
        attempts = max(1, int(self.attempts))
        if attempts == 1:
            return fn()
        cnt = counters if counters is not None else COUNTERS
        classify = retryable if retryable is not None else is_retryable
        t0 = time.monotonic()
        prev = self.base_s
        for attempt in range(1, attempts + 1):
            cnt.inc("retry.attempts")
            try:
                return fn()
            except BaseException as e:
                if not classify(e):
                    raise
                if attempt >= attempts:
                    cnt.inc("retry.giveups")
                    raise
                delay = self.next_backoff(prev)
                prev = delay
                hint = getattr(e, "retry_after_s", None)
                if hint:
                    delay = max(delay, float(hint))
                if self.total_budget_s is not None and \
                        (time.monotonic() - t0) + delay > self.total_budget_s:
                    cnt.inc("retry.budget_exhausted")
                    cnt.inc("retry.giveups")
                    raise
                cnt.inc("retry.retries")
                cnt.add("retry.backoff_s", delay)
                sleep(delay)


class CircuitBreaker:
    """Error-rate circuit breaker over the origin tier (module doc).
    ``allow``, ``record_success`` and ``record_failure`` are
    thread-safe; ``clock`` is injectable for deterministic tests."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, threshold: float = 0.5, *, window: int = 64,
                 min_samples: int = 10, cooldown_s: float = 1.0,
                 half_open_probes: int = 1, counters=None,
                 clock=time.monotonic):
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = max(1, int(half_open_probes))
        self._window = ErrorRateWindow(window)
        self._cnt = counters if counters is not None else COUNTERS
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probes = 0

    @property
    def state(self) -> str:
        """Current state, applying the cooldown transition (an idle
        breaker past its cooldown reports ``half_open``)."""
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self):
        # caller holds the lock
        if self._state == self.OPEN and \
                self._clock() - self._opened_at >= self.cooldown_s:
            self._state = self.HALF_OPEN
            self._probes = 0
            self._cnt.inc("breaker.half_opens")

    def retry_after_s(self) -> float:
        """Remaining cooldown (0 when not hard-open)."""
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(0.0, self.cooldown_s -
                       (self._clock() - self._opened_at))

    def allow(self) -> bool:
        """May this origin request proceed? Closed: yes. Open: no until
        the cooldown elapses. Half-open: yes for at most
        ``half_open_probes`` in-flight probes."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            self._maybe_half_open()
            if self._state == self.OPEN:
                self._cnt.inc("breaker.shed")
                return False
            if self._probes < self.half_open_probes:
                self._probes += 1
                self._cnt.inc("breaker.probes")
                return True
            self._cnt.inc("breaker.shed")
            return False

    def record_success(self):
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._probes = max(0, self._probes - 1)
                self._state = self.CLOSED
                self._window.reset()
                self._cnt.inc("breaker.closed")
            elif self._state == self.CLOSED:
                self._window.record(True)

    def record_failure(self):
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._probes = max(0, self._probes - 1)
                self._trip()
            elif self._state == self.CLOSED:
                self._window.record(False)
                if len(self._window) >= self.min_samples and \
                        self._window.error_rate() >= self.threshold:
                    self._trip()

    def _trip(self):
        # caller holds the lock
        self._state = self.OPEN
        self._opened_at = self._clock()
        self._window.reset()
        self._cnt.inc("breaker.opened")
