"""Demand-paged reads of an image through L1 -> peer -> L2 -> origin,
split into a fetch stage and a decode stage, and a page-granular
copy-on-write overlay over them (the port of ``repro.core.blockdev``:
``TieredReader`` with its peer tier, origin retries, circuit breaker
and GC root pins, and ``CowBlockDevice``).

  stage F — fetch only (``fetch_ciphertexts``): L1 probe ->
    single-flight claim -> peer probe (direct holder hits inline,
    names another worker provisions joined) -> one batched L2 stripe
    fetch -> parallel, limiter-bounded origin fetch, which fills the L2
    with every chunk it reads. Every chunk acquired from the L2 or the
    origin is published to the peer mesh.
  stage D — decode (``core.decode.BatchDecoder``): verify + decrypt
    whole tiles of ciphertexts.

Read APIs:

* serial (``fetch_chunk`` / ``read``): one chunk at a time through the
  per-chunk ``decrypt_chunk`` oracle;
* staged (``fetch_chunks``): stage F for the whole chunk set, then
  stage D;
* streamed (``fetch_chunks(..., streamed=True)``, the default restore):
  stage F on a producer thread pushes each resolved ciphertext into a
  ``BoundedQueue`` (L1 hits first, then each L2 reconstruction as its
  own stripe wave is served, then origin fetches) and
  ``BatchDecoder.decrypt_stream`` decodes tiles on the caller thread
  while fetch is still running;
* prefetch (``fetch_chunks(..., materialize=False)``): stage F only,
  warming the tiers; streamed, through the same producer with a
  consumer that discards what it is handed.

With a ``RootPinRegistry`` (``pins=``, ``core.gc``) every public read
entry point pins the reader's root for its duration, so a GC generation
roll can neither delete nor sweep the root under a restore in flight
(§3.4's epoch/pin protocol). The streamed producer thread calls the
pinned ``fetch_ciphertexts``, so it holds a pin of its own.

Concurrent fetches of one chunk name are single-flighted through a
``FlightTable`` that an ``ImageService`` shares across all its readers.
On an ``IntegrityError`` the offending names are evicted from L1, the
L2 and the peer mesh; with a ``RetryPolicy`` the read then restarts
(``integrity_refetches`` rounds), so the bad names come fresh from the
origin instead of replaying the bad bytes.

Origin GETs go through the resilience ladder (``core.retry``): a
``CircuitBreaker`` gate, the fetch limiter, a per-attempt deadline for
stores that take one, and ``RetryPolicy.call`` around the attempt.
``origin_delay_s`` optionally sleeps that long in each origin GET (a
simulated origin round trip; 0 by default).

Simulated latency (the paper's Fig. 11), bookkeeping only: every tier
returns the latency it simulates (an L1 probe ``L1_PROBE_S``, a peer
transfer, an L2 stripe wave, an origin GET ``ORIGIN_LAT_S`` after the
L2 miss it follows), and the reader carries it with each chunk. Each
read chunk lands in ``read_lat`` (``e2e.read``); each staged or
streamed batch records ``pipelined_latency`` of its fetched chunks at
its ``parallelism``, plus its L1 probes, in ``batch_lat``
(``e2e.read_batch``), and ``last_batch`` gives ``sim_serial_s`` (the
same chunks one after another) beside ``sim_pipelined_s``. A
single-flight follower takes its leader's latency. Nothing sleeps and
nothing syncs a device for it.

``CowBlockDevice`` adds the write path: writes land in an overlay of
4 KiB pages encrypted with the overlay key, marked in a dirty bitmap;
base chunks stay immutable, so every tier shares them. Reads take dirty
pages from the overlay and all clean spans through one ``read_many``,
and a write's read-modify-write base pages come through one
``read_many`` too.
"""
from __future__ import annotations

import contextlib
import functools
import heapq
import inspect
import itertools
import threading
import time
from concurrent.futures import FIRST_COMPLETED, wait

import numpy as np

from repro_torch.core.concurrency import QUEUE_DONE, BoundedQueue, LazyPool
from repro_torch.core.crypto import aes, convergent
from repro_torch.core.decode import BatchDecoder
from repro_torch.core.layout import ranges_to_chunks
from repro_torch.core.manifest import ZERO_CHUNK, Manifest
from repro_torch.core.retry import BreakerOpenError, is_retryable
from repro_torch.core.telemetry import COUNTERS, LatencyRecorder

PAGE = 4096
ORIGIN_LAT_S = 36e-3          # paper: S3 origin median 36 ms (simulated)
L1_PROBE_S = 2e-6
DEFAULT_PARALLELISM = 8
DEFAULT_QUEUE_DEPTH = 32      # streamed hand-off queue bound (chunks)


def _pinned(fn):
    """Hold the reader's GC root pin for the duration of a public read
    entry point (no-op without a registry; nested calls bump the
    count). See ``TieredReader._pin``."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        with self._pin():
            return fn(self, *args, **kwargs)
    return wrapped


def pipelined_latency(lats, lanes: int) -> float:
    """Wall-clock of running `lats` on `lanes` parallel workers, each
    job going to the least-loaded lane in submission order (what a
    thread pool does with equal-priority work). `lanes` is clamped to
    [1, len(lats)]; no jobs take 0.0."""
    lats = list(lats)
    if not lats:
        return 0.0
    lanes = max(1, min(int(lanes), len(lats)))
    heap = [0.0] * lanes
    for lat in lats:
        heapq.heapreplace(heap, heap[0] + lat)
    return max(heap)


class _Flight:
    """In-flight fetch for one chunk name (single-flight)."""

    __slots__ = ("event", "ciphertext", "sim_lat", "error")

    def __init__(self):
        self.event = threading.Event()
        self.ciphertext = None
        self.sim_lat = 0.0
        self.error = None


class FlightTable:
    """Shared single-flight registry: (root, chunk name) -> in-flight
    fetch. Names are content addresses, so one table serves every
    reader of a service: a stampede on one chunk from different images
    or tenants costs one origin fetch."""

    __slots__ = ("lock", "flights")

    def __init__(self):
        self.lock = threading.Lock()
        self.flights: dict[tuple, _Flight] = {}


class FetchedBatch:
    """Output of stage F: ciphertexts, each name's simulated fetch
    latency, and the index bookkeeping stage D needs to fan plaintexts
    back out."""

    __slots__ = ("by_name", "ciphertexts", "lats", "zero_indices",
                 "l1_lat", "l1_hits", "l2_hits", "sink")

    def __init__(self, sink: BoundedQueue | None = None):
        self.by_name: dict[str, list[int]] = {}     # name -> chunk indices
        self.ciphertexts: dict[str, bytes] = {}
        self.lats: dict[str, float] = {}            # simulated fetch lat
        self.zero_indices: list[int] = []
        self.l1_lat = 0.0                           # this batch's L1 probes
        self.l1_hits = 0
        self.l2_hits = 0
        self.sink = sink          # streamed hand-off; None = staged


class TieredReader:
    def __init__(self, manifest: Manifest, store, root: str | None = None,
                 l1=None, l2=None, concurrency=None,
                 origin_delay_s: float = 0.0,
                 decoder: BatchDecoder | None = None, counters=None,
                 flights: FlightTable | None = None, peer=None, pins=None,
                 retry=None, breaker=None):
        self.m = manifest
        self.store = store
        self.root = root or manifest.root_id
        self.l1 = l1
        self.l2 = l2
        # this worker's ``PeerClient`` into a shared ``PeerMesh``
        self.peer = peer
        self.concurrency = concurrency
        self.origin_delay_s = origin_delay_s
        self.decoder = decoder if decoder is not None else BatchDecoder()
        self.counters = counters if counters is not None else COUNTERS
        # a ``gc.RootPinRegistry``: every public read pins ``self.root``
        self.pins = pins
        self.read_lat = LatencyRecorder("e2e.read")
        self.batch_lat = LatencyRecorder("e2e.read_batch")
        self.last_batch: dict = {}
        self._refs = {c.index: c for c in manifest.chunks}
        table = flights if flights is not None else FlightTable()
        self._flights = table.flights
        self._flight_lock = table.lock
        self._fetch_pool = LazyPool()
        # can the L2 feed the stream per chunk (get_chunks(on_ready=))?
        # can it hedge straggler stripes (get_chunks(hedge=))?
        l2_get = getattr(l2, "get_chunks", None)
        l2_params = inspect.signature(l2_get).parameters if l2_get else {}
        self._l2_streams = "on_ready" in l2_params
        self._l2_hedges = "hedge" in l2_params
        # origin resilience: a ``RetryPolicy`` around every origin GET
        # and integrity round, a service-wide ``CircuitBreaker`` gating
        # origin GETs; both None by default
        self.retry = retry
        self.breaker = breaker
        store_get = getattr(store, "get_chunk", None)
        self._store_deadlines = store_get is not None and \
            "deadline_s" in inspect.signature(store_get).parameters

    def _pin(self):
        """Pin this reader's root for the duration of a read (no-op
        without a registry). Pins are counted, so nested public calls
        just nest."""
        if self.pins is None:
            return contextlib.nullcontext()
        return self.pins.pin(self.root)

    # ------------------------------------------------------------- chunks
    def _origin_get(self, name: str) -> bytes:
        """One origin GET through the resilience ladder: breaker gate,
        limiter, per-attempt deadline (for stores that take one), and
        retries of transient failures. The breaker records retryable
        outcomes only: a missing chunk is a bug, not origin weather."""
        def attempt() -> bytes:
            br = self.breaker
            if br is not None and not br.allow():
                raise BreakerOpenError(br.retry_after_s())
            limiter = self.concurrency if self.concurrency is not None \
                else contextlib.nullcontext()
            kw = {}
            if self._store_deadlines and self.retry is not None and \
                    self.retry.attempt_timeout_s is not None:
                kw["deadline_s"] = self.retry.attempt_timeout_s
            try:
                with limiter:
                    if self.origin_delay_s > 0:
                        time.sleep(self.origin_delay_s)
                    ct = self.store.get_chunk(self.root, name, **kw)
            except Exception as e:
                if br is not None and is_retryable(e):
                    br.record_failure()
                raise
            if br is not None:
                br.record_success()
            return ct

        if self.retry is None:
            return attempt()
        return self.retry.call(attempt, counters=self.counters)

    def _integrity_rounds(self, read):
        """`read()`, restarted after an ``IntegrityError`` (whose bad
        names `read` has evicted from every tier) up to the retry
        policy's ``integrity_refetches`` times; once without a policy."""
        rounds = 1 if self.retry is None \
            else 1 + max(0, int(self.retry.integrity_refetches))
        for round_ in range(rounds):
            try:
                return read()
            except convergent.IntegrityError:
                if round_ == rounds - 1:
                    raise
                self.counters.inc("retry.integrity_refetches")

    def _fetch_cipher(self, ref) -> tuple[bytes, float]:
        """(ciphertext, simulated latency) of `ref` from the peer mesh,
        else L2, else origin (which fills the L2), single-flighted by
        chunk name; what came from the L2 or the origin is published to
        the mesh. L1 is probed by callers."""
        with self._flight_lock:
            flight = self._flights.get((self.root, ref.name))
            leader = flight is None
            if leader:
                flight = self._flights[(self.root, ref.name)] = _Flight()
        if not leader:
            flight.event.wait()
            self.counters.inc("read.singleflight_dedup")
            if flight.error is not None:
                raise flight.error
            return flight.ciphertext, flight.sim_lat
        try:
            # (a flight may have backfilled L1)
            ct = self.l1.peek(ref.name) if self.l1 is not None else None
            lat = L1_PROBE_S if ct is not None else 0.0
            src = None
            if ct is None and self.peer is not None:
                # a miss leaves this worker leading the mesh flight: the
                # put_chunk or abandon below settles the lease
                plat, ct = self.peer.get_chunk(ref.name, self.m.chunk_size)
                lat += plat
                if ct is not None:
                    self.counters.inc("read.peer_hits")
                    if self.l1 is not None:
                        self.l1.put(ref.name, ct)
            if ct is None and self.l2 is not None:
                l2lat, ct = self.l2.get_chunk(ref.name, self.m.chunk_size)
                lat += l2lat
                if ct is not None:
                    src = "l2"
                    if self.l1 is not None:
                        self.l1.put(ref.name, ct)
            if ct is None:
                ct = self._origin_get(ref.name)
                lat += ORIGIN_LAT_S
                src = "origin"
                self.counters.inc("read.origin_fetches")
                if self.l2 is not None:
                    self.l2.put_chunk(ref.name, ct)
                if self.l1 is not None:
                    self.l1.put(ref.name, ct)
            if src is not None and self.peer is not None:
                self.peer.put_chunk(ref.name, ct, source=src)
            flight.ciphertext = ct
            flight.sim_lat = lat
            return ct, lat
        except Exception as e:
            flight.error = e
            if self.peer is not None:
                # promote a joiner instead of stranding the tree (no-op
                # when another worker leads)
                self.peer.abandon(ref.name)
            raise
        finally:
            with self._flight_lock:
                self._flights.pop((self.root, ref.name), None)
            flight.event.set()

    @_pinned
    def fetch_chunk(self, index: int) -> bytes:
        """Plaintext of chunk `index` (serial, per-chunk oracle). A
        tampered ciphertext is evicted from every tier before the error
        propagates or, with a retry policy, the chunk is refetched. The
        chunk's simulated latency (L1 probe and fetch) lands in
        ``read_lat`` once it decrypts."""
        ref = self._refs[index]
        if ref.name == ZERO_CHUNK:
            self.counters.inc("read.zero_chunks")
            return b"\x00" * self.m.chunk_size

        def once() -> bytes:
            lat = 0.0
            ct = None
            if self.l1 is not None:
                ct = self.l1.get(ref.name)
                lat += L1_PROBE_S
            if ct is not None:
                self.counters.inc("read.l1_hits")
            else:
                ct, fetch_lat = self._fetch_cipher(ref)
                lat += fetch_lat
            try:
                plain = convergent.decrypt_chunk(ct, ref.key, ref.sha256)
            except convergent.IntegrityError:
                self._invalidate_name(ref.name)
                raise
            self.read_lat.record(lat)
            return plain
        return self._integrity_rounds(once)

    # ------------------------------------------------- stage F: fetch I/O
    @_pinned
    def fetch_ciphertexts(self, indices,
                          parallelism: int = DEFAULT_PARALLELISM,
                          sink: BoundedQueue | None = None,
                          l2_hedge: bool | None = None) -> FetchedBatch:
        """Pull every distinct chunk name of `indices` as CIPHERTEXT: L1
        hits first, then the names this call leads through one batched
        L2 fetch and single-flighted origin fetches on a
        `parallelism`-wide pool; names another thread leads are waited
        on last. With a `sink`, every resolved ``(name, ciphertext)`` is
        also pushed into the bounded queue as it lands. ``l2_hedge``
        overrides the L2's hedged-GET default for this batch (None
        inherits); it is forwarded only when the L2 supports it."""
        fb = FetchedBatch(sink)
        for i in sorted(set(int(i) for i in indices)):
            ref = self._refs[i]
            if ref.name == ZERO_CHUNK:
                self.counters.inc("read.zero_chunks")
                fb.zero_indices.append(i)
            else:
                fb.by_name.setdefault(ref.name, []).append(i)
        miss = []
        for name in fb.by_name:
            if self.l1 is not None:
                ct = self.l1.get(name)
                fb.l1_lat += L1_PROBE_S
                if ct is not None:
                    fb.ciphertexts[name] = ct
                    fb.lats[name] = L1_PROBE_S
                    fb.l1_hits += 1
                    self.counters.inc("read.l1_hits")
                    self.read_lat.record(L1_PROBE_S)
                    if fb.sink is not None:
                        fb.sink.put((name, ct))
                    continue
            miss.append(name)
        if not miss:
            return fb
        lead, follow = {}, {}
        with self._flight_lock:
            for name in miss:
                flight = self._flights.get((self.root, name))
                if flight is None:
                    flight = self._flights[(self.root, name)] = _Flight()
                    lead[name] = flight
                else:
                    follow[name] = flight
        if lead:
            self._fetch_leaders(lead, parallelism, fb, l2_hedge)
        for name, flight in follow.items():
            flight.event.wait()
            self.counters.inc("read.singleflight_dedup")
            if flight.error is not None:
                raise flight.error
            fb.ciphertexts[name] = flight.ciphertext
            fb.lats[name] = flight.sim_lat
            self.read_lat.record(flight.sim_lat)
            if fb.sink is not None:
                fb.sink.put((name, flight.ciphertext))
        return fb

    def _resolve_flight(self, name: str, flight: _Flight, ct: bytes,
                        lat: float, fb: FetchedBatch, push: bool = True):
        flight.ciphertext = ct
        flight.sim_lat = lat
        with self._flight_lock:
            self._flights.pop((self.root, name), None)
        flight.event.set()
        fb.ciphertexts[name] = ct
        fb.lats[name] = lat
        self.read_lat.record(lat)
        # push AFTER event.set(): a flight's waiters never wait on sink
        # backpressure
        if push and fb.sink is not None:
            fb.sink.put((name, ct))

    def _poison_flight(self, name: str, flight: _Flight, error: Exception):
        flight.error = error
        with self._flight_lock:
            self._flights.pop((self.root, name), None)
        flight.event.set()
        if self.peer is not None:
            # release a mesh lease we hold for this name (no-op when
            # another worker leads)
            self.peer.abandon(name)

    def _fetch_leaders(self, lead: dict, parallelism: int,
                       fb: FetchedBatch, l2_hedge: bool | None = None):
        """The names this call leads: L1 double-check (a previous flight
        may have backfilled it), the peer probe, then one batched L2
        fetch and the parallel origin stage. Every claimed flight is
        resolved or poisoned, even on an interrupt.

        The peer probe does not block on names another worker is
        provisioning: holder hits resolve inline, such names are joined
        on peer pool threads (futures), and only the names this worker
        now leads in the mesh fall through at once. The joined futures
        are drained after that fall-through (two workers each leading a
        name the other joined must both make progress), as they finish:
        the joins that came back empty (promotion, a dead peer, the
        deadline) by the time of each wake-up fall through together
        (``read.peer_fallthroughs``) before the next wait. An orphan
        promoted to lead a name after its leader crashed therefore
        fetches it at once, and the other orphans joined on it are not
        held behind this call's unrelated joins. (The JAX package drains
        in probe order with a blocking wait per name, so there the
        promoted orphans fetch only after every join of the call has
        finished, and their joiners sit out ``peer_deadline_s``.)"""
        unresolved = dict(lead)
        try:
            pending = []
            for name in lead:
                ct = self.l1.peek(name) if self.l1 is not None else None
                if ct is not None:
                    self._resolve_flight(name, unresolved.pop(name), ct,
                                         L1_PROBE_S, fb)
                else:
                    pending.append(name)
            peer_futs: dict = {}
            if pending and self.peer is not None:
                def peer_ready(name, lat, ct):
                    # inline for holder hits, on a peer pool thread for
                    # joined flights; the error path may have poisoned
                    # this name already
                    flight = unresolved.pop(name, None)
                    if flight is None:
                        return
                    self.counters.inc("read.peer_hits")
                    if self.l1 is not None:
                        self.l1.put(name, ct)
                    self._resolve_flight(name, flight, ct, lat, fb)
                pending, peer_futs = self.peer.probe_chunks(
                    pending, self.m.chunk_size, peer_ready)
            if pending:
                self._fall_through(pending, parallelism, fb, unresolved,
                                   l2_hedge)
            joined = {fut: name for name, fut in peer_futs.items()}
            rank = {name: k for k, name in enumerate(peer_futs)}
            waiting = set(joined)
            while waiting:
                done, waiting = wait(waiting, return_when=FIRST_COMPLETED)
                again = sorted((joined[f] for f in done
                                if f.result()[1] is None
                                and joined[f] in unresolved), key=rank.get)
                if again:
                    self.counters.add("read.peer_fallthroughs", len(again))
                    self._fall_through(again, parallelism, fb, unresolved,
                                       l2_hedge)
        except BaseException as e:
            for name in list(unresolved):
                flight = unresolved.pop(name, None)
                if flight is not None:      # else a peer thread resolved it
                    self._poison_flight(name, flight, e)
            raise

    def _fall_through(self, pending: list, parallelism: int,
                      fb: FetchedBatch, unresolved: dict,
                      l2_hedge: bool | None = None):
        """The lower tiers for `pending` led names: one batched L2
        fetch, then the parallel origin stage. An origin GET's simulated
        latency adds to the L2 miss before it."""
        l2_lat = self._l2_stage(pending, unresolved, fb, l2_hedge) \
            if self.l2 is not None else dict.fromkeys(pending, 0.0)
        if l2_lat:
            self._origin_stage(l2_lat, parallelism, unresolved, fb)

    def _l2_stage(self, pending: list, unresolved: dict, fb: FetchedBatch,
                  l2_hedge: bool | None) -> dict:
        """One batched L2 fetch of `pending` names; returns the misses
        as {name: simulated latency of the miss}, in `pending` order.
        Streamed (a sink and an L2 that takes ``on_ready``): each chunk
        resolves and feeds the sink as soon as its own stripe wave is
        served and rebuilt, instead of after every chunk's wave."""
        cs = self.m.chunk_size
        kw = {"hedge": l2_hedge} \
            if self._l2_hedges and l2_hedge is not None else {}

        def hit(name, lat, ct):
            fb.l2_hits += 1
            if self.l1 is not None:
                self.l1.put(name, ct)
            if self.peer is not None:
                self.peer.put_chunk(name, ct, source="l2")
            self._resolve_flight(name, unresolved.pop(name), ct, lat, fb)

        if self._l2_streams and fb.sink is not None:
            res = self.l2.get_chunks(pending, cs, on_ready=hit, **kw)
            return {n: res[n][0] for n in pending if res[n][1] is None}
        res = self.l2.get_chunks(pending, cs, **kw)
        still = {}
        for name in pending:
            lat, ct = res[name]
            if ct is None:
                still[name] = lat
            else:
                hit(name, lat, ct)
        return still

    def _origin_stage(self, l2_lat: dict, parallelism: int,
                      unresolved: dict, fb: FetchedBatch):
        """Parallel origin fetch of the names of `l2_lat` ({name:
        simulated latency of its L2 miss}), at most `parallelism` in
        flight. A failed fetch poisons only its own flight; never-started
        names inherit the first error, which is raised once the stage
        drains."""
        def fetch_origin(name: str):
            ct = self._origin_get(name)
            self.counters.inc("read.origin_fetches")
            if self.l2 is not None:
                self.l2.put_chunk(name, ct)
            if self.l1 is not None:
                self.l1.put(name, ct)
            if self.peer is not None:
                self.peer.put_chunk(name, ct, source="origin")
            return ct, l2_lat[name] + ORIGIN_LAT_S

        first_err = None
        workers = max(1, min(int(parallelism), len(l2_lat)))
        name_iter = iter(l2_lat)
        pool = self._fetch_pool.get(workers)
        fut_name = {pool.submit(fetch_origin, n): n
                    for n in itertools.islice(name_iter, workers)}
        while fut_name:
            done, _ = wait(fut_name, return_when=FIRST_COMPLETED)
            pushes = []
            for fut in done:
                name = fut_name.pop(fut)
                try:
                    ct, lat = fut.result()
                except BaseException as e:
                    self._poison_flight(name, unresolved.pop(name), e)
                    if first_err is None:
                        first_err = e
                    continue
                # resolve the whole wave (and submit replacements) before
                # any sink push: backpressure must not delay landed bytes
                self._resolve_flight(name, unresolved.pop(name), ct, lat,
                                     fb, push=False)
                pushes.append((name, ct))
                if first_err is None:
                    nxt = next(name_iter, None)
                    if nxt is not None:
                        fut_name[pool.submit(fetch_origin, nxt)] = nxt
            if fb.sink is not None:
                for name, ct in pushes:
                    fb.sink.put((name, ct))
        if first_err is not None:
            for name in name_iter:
                self._poison_flight(name, unresolved.pop(name), first_err)
            raise first_err

    # ------------------------------------------------- stage F + stage D
    def _invalidate_name(self, name: str):
        """Evict one tamper-flagged chunk name from L1, the L2 and the
        peer mesh (directory entry and every holder's copy, so no later
        reader is served the bad copy peer-to-peer)."""
        for tier in (self.l1, self.l2, self.peer):
            if tier is not None:
                tier.invalidate(name)

    def _invalidate_bad(self, err: convergent.IntegrityError):
        for name in err.bad_positions:
            if isinstance(name, str):
                self._invalidate_name(name)

    @_pinned
    def fetch_chunks(self, indices, parallelism: int = DEFAULT_PARALLELISM,
                     materialize: bool = True, streamed: bool = False,
                     queue_depth: int = DEFAULT_QUEUE_DEPTH,
                     decoder: BatchDecoder | None = None,
                     l2_hedge: bool | None = None) -> dict:
        """{index: plaintext} for a deduplicated chunk set: stage F then
        one batched stage D (staged), or both at once (``streamed``,
        ``fetch_chunks_streamed``). Byte-identical either way. After an
        ``IntegrityError`` the bad names are evicted from every tier and,
        with a retry policy, the read restarts: the good names are warm
        L1 hits, the bad ones come from the origin again.

        ``materialize=False`` (prefetch) skips stage D: the tiers are
        warmed and the result is empty. Streamed, it runs the streaming
        producer with a consumer that discards the ciphertexts
        (``_prefetch_streamed``), the fetch path a streamed restore
        takes."""
        if streamed and materialize:
            return self.fetch_chunks_streamed(indices, parallelism,
                                              queue_depth, decoder, l2_hedge)
        if streamed:
            return self._prefetch_streamed(indices, parallelism, queue_depth,
                                           l2_hedge)
        return self._integrity_rounds(lambda: self._fetch_chunks_staged(
            indices, parallelism, materialize, decoder, l2_hedge))

    def _fetch_chunks_staged(self, indices, parallelism: int,
                             materialize: bool,
                             decoder: BatchDecoder | None,
                             l2_hedge: bool | None) -> dict:
        dec = decoder if decoder is not None else self.decoder
        t0 = time.perf_counter()
        fb = self.fetch_ciphertexts(indices, parallelism, l2_hedge=l2_hedge)
        fetch_wall = time.perf_counter() - t0
        out: dict[int, bytes] = {}
        decode_wall = 0.0
        if materialize and fb.zero_indices:
            zero = b"\x00" * self.m.chunk_size
            for i in fb.zero_indices:
                out[i] = zero
        if materialize and fb.by_name:
            refs = [self._refs[idxs[0]] for idxs in fb.by_name.values()]
            try:
                plains, decode_wall = dec.decrypt_batch_timed(
                    refs, fb.ciphertexts)
            except convergent.IntegrityError as e:
                self._invalidate_bad(e)
                raise
            for name, idxs in fb.by_name.items():
                for i in idxs:
                    out[i] = plains[name]
        self._record_batch(fb, parallelism, t0, fetch_wall, decode_wall,
                           dec, streamed=False)
        return out

    def _prefetch_streamed(self, indices, parallelism: int,
                           queue_depth: int,
                           l2_hedge: bool | None = None) -> dict:
        """Non-materialising streamed prefetch: the streaming producer
        warms every tier while this thread drains and drops the
        ciphertext stream (no decode). Returns {}."""
        t0 = time.perf_counter()
        q = BoundedQueue(queue_depth)
        holder: dict = {}

        def produce():
            try:
                holder["fb"] = self.fetch_ciphertexts(
                    indices, parallelism, sink=q, l2_hedge=l2_hedge)
            except BaseException as e:
                q.poison(e)
            else:
                q.close()

        prod = threading.Thread(target=produce, name="prefetch-fetch",
                                daemon=True)
        prod.start()
        try:
            while q.get() is not QUEUE_DONE:
                pass            # drain: the tiers warm, nothing decodes
        except BaseException:
            q.cancel()          # producer puts now drop
            prod.join()
            raise
        prod.join()
        fb: FetchedBatch = holder["fb"]
        nchunks = len(fb.zero_indices) + sum(len(v)
                                             for v in fb.by_name.values())
        self.counters.add("read.batched_chunks", nchunks)
        self.counters.max_update("stream.queue_hwm", q.high_water)
        self.last_batch = {
            "chunks": nchunks,
            "fetched": len(fb.by_name) - fb.l1_hits,
            "parallelism": int(parallelism),
            "wall_s": time.perf_counter() - t0,
            "streamed": True,
            "materialized": False,
            "queue_hwm": q.high_water,
            "queue_depth": q.maxsize,
        }
        return {}

    @_pinned
    def fetch_chunks_streamed(self, indices,
                              parallelism: int = DEFAULT_PARALLELISM,
                              queue_depth: int = DEFAULT_QUEUE_DEPTH,
                              decoder: BatchDecoder | None = None,
                              l2_hedge: bool | None = None) -> dict:
        """Streaming read: stage F on a producer thread pushing resolved
        ciphertexts into a ``queue_depth``-bounded queue; stage D
        (``decoder.decrypt_stream``) on this thread. ``last_batch``
        adds ``overlap_s`` (decode work hidden under the fetch wall),
        ``overlap_fraction`` and the queue's high-water mark. Integrity
        failures restart the read as in ``fetch_chunks``."""
        return self._integrity_rounds(lambda: self._fetch_streamed_once(
            indices, parallelism, queue_depth, decoder, l2_hedge))

    def _fetch_streamed_once(self, indices, parallelism: int,
                             queue_depth: int,
                             decoder: BatchDecoder | None,
                             l2_hedge: bool | None) -> dict:
        dec = decoder if decoder is not None else self.decoder
        t0 = time.perf_counter()
        refs_by_name: dict[str, object] = {}
        for i in set(int(i) for i in indices):
            ref = self._refs[i]
            if ref.name != ZERO_CHUNK:
                refs_by_name.setdefault(ref.name, ref)
        q = BoundedQueue(queue_depth)
        holder: dict = {}

        def produce():
            ft = time.perf_counter()
            try:
                holder["fb"] = self.fetch_ciphertexts(
                    indices, parallelism, sink=q, l2_hedge=l2_hedge)
            except BaseException as e:
                q.poison(e)
            else:
                q.close()
            finally:
                holder["fetch_wall"] = time.perf_counter() - ft

        prod = threading.Thread(target=produce, name="stream-fetch",
                                daemon=True)
        prod.start()
        try:
            plains, dstats = dec.decrypt_stream(q, refs_by_name)
        except BaseException as e:
            q.cancel()          # producer puts now drop
            prod.join()
            if isinstance(e, convergent.IntegrityError):
                self._invalidate_bad(e)
            raise
        prod.join()
        fb: FetchedBatch = holder["fb"]
        out: dict[int, bytes] = {}
        if fb.zero_indices:
            zero = b"\x00" * self.m.chunk_size
            for i in fb.zero_indices:
                out[i] = zero
        for name, idxs in fb.by_name.items():
            for i in idxs:
                out[i] = plains[name]
        total = time.perf_counter() - t0
        fetch_wall = holder["fetch_wall"]
        busy = dstats["busy_s"]
        # decode work outside the post-fetch tail ran under the fetch
        # wall; clamp to the fetch window
        overlap = max(0.0, min(busy - max(0.0, total - fetch_wall),
                               fetch_wall))
        self.counters.add("decode.overlap_s", overlap)
        self.counters.max_update("stream.queue_hwm", q.high_water)
        self._record_batch(fb, parallelism, t0, fetch_wall, busy, dec,
                           streamed=True)
        self.last_batch.update({
            "overlap_s": overlap,
            "overlap_fraction": overlap / busy if busy > 0 else 0.0,
            "queue_hwm": q.high_water,
            "queue_depth": q.maxsize,
            "decode_tiles": dstats["tiles"],
            "eager_flushes": dstats.get("eager_flushes", 0),
            "eager_holds": dstats.get("eager_holds", 0),
        })
        return out

    def _record_batch(self, fb, parallelism, t0, fetch_wall, decode_wall,
                      dec, streamed: bool):
        """``last_batch`` of a staged or streamed batch, and its
        simulated wall in ``batch_lat``: the L1 probes, then the fetched
        chunks (L1 hits excluded) on `parallelism` lanes."""
        fetch_lats = [lat for lat in fb.lats.values() if lat > L1_PROBE_S]
        sim_wall = fb.l1_lat + pipelined_latency(fetch_lats, parallelism)
        self.batch_lat.record(sim_wall)
        nchunks = len(fb.zero_indices) + sum(len(v)
                                             for v in fb.by_name.values())
        self.counters.add("read.batched_chunks", nchunks)
        self.last_batch = {
            "chunks": nchunks,
            "fetched": len(fb.by_name) - fb.l1_hits,
            "l2_hits": fb.l2_hits,
            "parallelism": int(parallelism),
            "sim_serial_s": fb.l1_lat + sum(fetch_lats),
            "sim_pipelined_s": sim_wall,
            "wall_s": time.perf_counter() - t0,
            "fetch_wall_s": fetch_wall,
            "decode_wall_s": decode_wall,
            "decode_backend": dec.backend,
            "streamed": streamed,
        }

    # -------------------------------------------------------------- bytes
    def _assemble(self, offset: int, length: int, chunks: dict) -> bytes:
        """Bytes of [offset, offset+length) from prefetched `chunks`
        (a serial fetch for anything missing)."""
        cs = self.m.chunk_size
        parts = []
        pos, end = offset, offset + length
        while pos < end:
            ci, within = divmod(pos, cs)
            take = min(cs - within, end - pos)
            chunk = chunks.get(ci)
            if chunk is None:
                chunk = self.fetch_chunk(ci)
            parts.append(chunk[within:within + take]
                         if (within, take) != (0, len(chunk)) else chunk)
            pos += take
        return b"".join(parts)

    @_pinned
    def read(self, offset: int, length: int) -> bytes:
        """Serial read: chunks fetched one at a time, in order."""
        return self._assemble(offset, length, {})

    @_pinned
    def read_many(self, ranges, parallelism: int = DEFAULT_PARALLELISM,
                  streamed: bool = False,
                  queue_depth: int = DEFAULT_QUEUE_DEPTH,
                  decoder: BatchDecoder | None = None,
                  l2_hedge: bool | None = None) -> list:
        """One ``fetch_chunks`` over the union chunk set of all
        (offset, length) `ranges`, then each range assembled from the
        in-memory chunks. Byte-identical to ``read`` per range."""
        ranges = list(ranges)
        idxs = ranges_to_chunks(ranges, self.m.chunk_size)
        chunks = self.fetch_chunks(idxs, parallelism, streamed=streamed,
                                   queue_depth=queue_depth, decoder=decoder,
                                   l2_hedge=l2_hedge)
        return [self._assemble(off, ln, chunks) for off, ln in ranges]


class CowBlockDevice:
    """Read/write device: an immutable base (``TieredReader``) and an
    overlay of PAGE-sized pages, encrypted at rest with `overlay_key`
    (AES-256-CTR, the page number as IV), marked in a dirty bitmap. A
    sub-page write reads, modifies and writes its page back (§2.1).
    Reads batch every clean span into one ``read_many``."""

    def __init__(self, reader: TieredReader, overlay_key: bytes | None = None):
        self.reader = reader
        self.size = reader.m.image_size
        self.npages = (self.size + PAGE - 1) // PAGE
        self.bitmap = np.zeros(self.npages, dtype=bool)
        self._overlay: dict[int, bytes] = {}      # page -> ciphertext
        self.key = overlay_key or b"\x01" * 32

    def _store_page(self, page: int, plain: bytes):
        iv = page.to_bytes(16, "big")
        self._overlay[page] = aes.ctr_encrypt(plain, self.key, iv16=iv)
        self.bitmap[page] = True

    def _load_page(self, page: int) -> bytes:
        iv = page.to_bytes(16, "big")
        return aes.ctr_decrypt(self._overlay[page], self.key, iv16=iv)

    def _clean_spans(self, offset: int, end: int) -> list:
        """Maximal contiguous non-overlay byte runs within [offset, end)."""
        spans: list[list[int]] = []
        pos = offset
        while pos < end:
            page = pos // PAGE
            take = min(PAGE - pos % PAGE, end - pos)
            if not (page < self.npages and self.bitmap[page]):
                if spans and spans[-1][0] + spans[-1][1] == pos:
                    spans[-1][1] += take
                else:
                    spans.append([pos, take])
            pos += take
        return [(o, ln) for o, ln in spans]

    def read(self, offset: int, length: int,
             parallelism: int = DEFAULT_PARALLELISM) -> bytes:
        end = offset + length
        spans = self._clean_spans(offset, end)
        fetched: dict[int, bytes] = {}
        if spans:
            # clamp to the image; anything past it reads as zeros
            capped = [(o, max(0, min(ln, self.size - o))) for o, ln in spans]
            bufs = iter(self.reader.read_many(
                [(o, ln) for o, ln in capped if ln > 0], parallelism))
            for (o, ln), (_, cln) in zip(spans, capped):
                data = next(bufs) if cln > 0 else b""
                fetched[o] = data.ljust(ln, b"\x00")
        out = bytearray()
        pos = offset
        while pos < end:
            page = pos // PAGE
            within = pos % PAGE
            take = min(PAGE - within, end - pos)
            if page < self.npages and self.bitmap[page]:
                out += self._load_page(page)[within:within + take]
                pos += take
            else:
                span = fetched[pos]      # the whole clean span from here
                out += span
                pos += len(span)
        return bytes(out)

    def _base_pages_batched(self, pages: list,
                            parallelism: int = DEFAULT_PARALLELISM) -> dict:
        """{page: PAGE bytes} of base-image content for `pages`, through
        one ``read_many`` (pages past the image end read as zeros)."""
        capped = [(p, min(PAGE, self.size - p * PAGE)) for p in pages]
        ranges = [(p * PAGE, ln) for p, ln in capped if ln > 0]
        bufs = iter(self.reader.read_many(ranges, parallelism)) if ranges \
            else iter(())
        return {p: (next(bufs).ljust(PAGE, b"\x00") if ln > 0
                    else b"\x00" * PAGE)
                for p, ln in capped}

    def write(self, offset: int, data: bytes,
              parallelism: int = DEFAULT_PARALLELISM):
        pos, end = offset, offset + len(data)
        # only the partially covered edge pages need their base bytes;
        # fetch all of them through one read_many
        need_base = []
        while pos < end:
            page = pos // PAGE
            within = pos % PAGE
            take = min(PAGE - within, end - pos)
            partial = not (within == 0 and take == PAGE)
            if partial and not (page < self.npages and self.bitmap[page]):
                need_base.append(page)
            pos += take
        base_pages = self._base_pages_batched(need_base, parallelism) \
            if need_base else {}
        pos, src = offset, 0
        while pos < end:
            page = pos // PAGE
            within = pos % PAGE
            take = min(PAGE - within, end - pos)
            if within == 0 and take == PAGE:
                pagebuf = data[src:src + PAGE]
            else:
                base = self._load_page(page) if self.bitmap[page] \
                    else base_pages[page]
                pagebuf = base[:within] + data[src:src + take] \
                    + base[within + take:]
            self._store_page(page, pagebuf)
            pos += take
            src += take

    @property
    def dirty_bytes(self) -> int:
        return int(self.bitmap.sum()) * PAGE
