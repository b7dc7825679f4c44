"""Concurrency limiting (paper §4.2): the metastability guard.

Cold starts are concurrency-limited; when in-flight work exceeds the
limit, new starts are REJECTED (not queued) until in-flight ones complete,
which bounds the demand amplification of an empty cache (Little's-law
spiral).

``BoundedQueue`` is the hand-off primitive of the streaming fetch→decode
pipeline: the fetch producer pushes resolved ciphertexts as they land,
the decode consumer drains them into tiles, and the bound gives
backpressure — a slow decode stage throttles fetch instead of buffering
the whole image in memory."""
from __future__ import annotations

import threading
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from repro_torch.core.telemetry import COUNTERS

QUEUE_DONE = object()           # end-of-stream sentinel (``get``/``try_get``)
QUEUE_EMPTY = object()          # ``try_get``: nothing queued right now


class BoundedQueue:
    """Bounded, closable hand-off queue between one producer stage and
    one consumer stage (the streaming pipeline's backpressure primitive).

    Contract:

    * ``put(item)`` blocks while the queue holds ``maxsize`` items; after
      ``cancel()`` it stops blocking and returns ``False``, silently
      dropping the item, so a producer never deadlocks on a consumer
      that has bailed out (e.g. on a decode error).
    * ``close()``: producer finished; iteration ends once drained.
    * ``poison(exc)``: producer failed; the consumer drains any items
      already queued, then ``exc`` is raised from its next ``get()``.
    * ``cancel()``: consumer gone; blocked and future puts drop.
    * ``high_water`` is the maximum depth ever reached.

    One producer + one consumer is the intended use; all methods are
    nonetheless thread-safe.
    """

    def __init__(self, maxsize: int):
        self.maxsize = max(1, int(maxsize))
        self._dq: deque = deque()
        self._mu = threading.Lock()
        self._not_full = threading.Condition(self._mu)
        self._not_empty = threading.Condition(self._mu)
        self._closed = False
        self._cancelled = False
        self._error: BaseException | None = None
        self.high_water = 0

    def put(self, item) -> bool:
        with self._mu:
            while len(self._dq) >= self.maxsize and not self._cancelled:
                self._not_full.wait()
            if self._cancelled:
                return False
            assert not self._closed, "put() after close()"
            self._dq.append(item)
            self.high_water = max(self.high_water, len(self._dq))
            self._not_empty.notify()
            return True

    def close(self):
        with self._mu:
            self._closed = True
            self._not_empty.notify_all()

    def poison(self, exc: BaseException):
        with self._mu:
            self._error = exc
            self._closed = True
            self._not_empty.notify_all()

    def cancel(self):
        with self._mu:
            self._cancelled = True
            self._not_full.notify_all()
            self._not_empty.notify_all()

    def get(self):
        """Next item; raises the poison error (drained-first) or returns
        the internal DONE sentinel once closed and empty."""
        with self._mu:
            while not self._dq and not self._closed:
                self._not_empty.wait()
            if self._dq:
                item = self._dq.popleft()
                self._not_full.notify()
                return item
            if self._error is not None:
                raise self._error
            return QUEUE_DONE

    def try_get(self):
        """Non-blocking ``get``: an item, ``QUEUE_EMPTY`` when nothing is
        queued yet (the producer is still running), or ``QUEUE_DONE``
        once closed and drained. The idle-queue eager flush reads
        ``QUEUE_EMPTY`` as 'the consumer would block now'."""
        with self._mu:
            if self._dq:
                item = self._dq.popleft()
                self._not_full.notify()
                return item
            if not self._closed:
                return QUEUE_EMPTY
            if self._error is not None:
                raise self._error
            return QUEUE_DONE


class LazyPool:
    """Lazily-created ThreadPoolExecutor, grown on demand, never shrunk
    — the shared pool idiom of the fetch/decode/stripe stages.

    ``get(workers)`` returns a pool at least `workers` wide. Growing
    ABANDONS the narrower pool instead of shutting it down: a concurrent
    narrower batch may be racing its submissions against the growth.
    Every created pool's shutdown is tied to this object's lifetime via
    ``weakref.finalize``, so worker threads don't outlive the owner
    holding the LazyPool."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None
        self._size = 0

    def get(self, workers: int) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None or self._size < workers:
                self._pool = ThreadPoolExecutor(max_workers=workers)
                self._size = workers
                weakref.finalize(self, self._pool.shutdown, wait=False)
            return self._pool

    def shutdown(self, wait: bool = True):
        """Drain and release the current pool (``ImageService.close()``
        / ``BatchDecoder.close()``). Safe to call repeatedly; a later
        ``get`` lazily builds a fresh pool."""
        with self._lock:
            pool, self._pool, self._size = self._pool, None, 0
        if pool is not None:
            pool.shutdown(wait=wait)


class RejectingLimiter:
    def __init__(self, max_inflight: int):
        self.max_inflight = max_inflight
        self._lock = threading.Lock()
        self.inflight = 0
        self.rejected = 0
        self.admitted = 0

    def try_acquire(self) -> bool:
        with self._lock:
            if self.inflight >= self.max_inflight:
                self.rejected += 1
                COUNTERS.inc("limiter.rejected")
                return False
            self.inflight += 1
            self.admitted += 1
            return True

    def shed(self):
        """Count a rejection decided above the limiter (the service's
        breaker-open brownout sheds before trying for a slot), so
        ``rejected`` stays the one count of arrivals turned away."""
        with self._lock:
            self.rejected += 1
            COUNTERS.inc("limiter.rejected")

    def release(self):
        # clamp at zero: a double-release (finally-block running after a
        # failed try_acquire path, say) must not drive inflight negative
        # and silently widen the admission gate by one forever
        with self._lock:
            if self.inflight <= 0:
                COUNTERS.inc("limiter.release_underflow")
                return
            self.inflight -= 1


class BlockingLimiter:
    """For internal fetch paths: bounds concurrent origin reads.

    The batched reader's fetch pool acquires this around every origin
    GET, so total origin concurrency stays bounded no matter how many
    batches or readers are in flight. Usable as a context manager."""

    def __init__(self, max_inflight: int):
        self.max_inflight = max_inflight
        self._sem = threading.BoundedSemaphore(max_inflight)

    def acquire(self):
        self._sem.acquire()

    def release(self):
        try:
            self._sem.release()
        except ValueError:      # BoundedSemaphore: more releases than acquires
            COUNTERS.inc("limiter.release_underflow")

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False
