"""L2: the AZ-level distributed cache (paper §4), resilience-first. A
copy of ``repro.core.cache.distributed`` whose erasure coder takes the
port's kernel hooks (``kernels.parity`` on every fill, ``kernels.gf256``
in the batched reconstruction).

Real data paths — consistent-hash placement, two-tier (memory + flash)
LRU-k storage per node, erasure-coded stripes, constant-work fetch with
reconstruction from the first k of n responses — plus an injected
per-request latency model (one process, not a fleet). Nothing sleeps:
the latencies are simulated and reported.

Constant-work property (paper §4.1): a fetch ALWAYS issues n stripe
requests and needs any k; node failure or slowness changes nothing about
the work done.

Three resilience layers sit between the reader and the simulated fleet:

* **Fault layer** — every node carries a ``FaultPlan`` (healthy /
  crashed / blackholed / slow), switchable mid-flight via
  ``set_fault``. Fault responses flow through the same latency model
  and recorders as healthy ones, and the client applies a per-stripe
  deadline (``stripe_deadline_s``) so a blackholed node costs a bounded
  timeout, not a hang.
* **Hot-key layer** — a chunk whose windowed request rate crosses
  ``infection_threshold`` is "infected" and salted into ``salt_count``
  placement keys (``name``, ``name#s1``, ...). Reads round-robin across
  the salts, writes fan out to every salt, invalidation drops every
  salt. Off by default.
* **Tail-cutting layer** — hedged stripe GETs: with ``hedge_quantile``
  set (or ``get_chunks(hedge=True)``), any stripe response slower than
  that quantile of the recent stripe-latency window races one extra
  request against the same node; the effective latency is the earlier
  of the two. Hedges are counted (``l2.hedges`` / ``l2.hedge_wins``).
  Off by default.

Stripe requests go through a shared thread pool. The batched
``get_chunks`` reconstructs every hit through one
``ErasureCoder.decode_many`` call (one GF matmul per erasure signature);
in streaming mode (``get_chunks(..., on_ready=...)``) each chunk is
instead rebuilt with the per-chunk numpy ``decode`` the moment its k-th
stripe lands and handed to the callback.

Measurement and control: every hit's latency lands in ``fetch_lat``
(``l2.fetch``) and each node's served and refused requests in its
``get_lat``/``put_lat``; ``get_chunk_unreplicated`` is Fig. 9's 4-of-4
read (all k data stripes, no parity) to hold the 4-of-5 tail against;
``fail_node``, ``flush`` and ``hit_rate`` crash or heal a node, empty
the cluster and read its hit rate.
"""
from __future__ import annotations

import math
import threading
from concurrent.futures import FIRST_COMPLETED, wait
from dataclasses import dataclass

import numpy as np

from repro_torch.core.cache.hashring import HashRing, HotKeyTracker
from repro_torch.core.cache.lru_k import LRUK
from repro_torch.core.concurrency import LazyPool
from repro_torch.core.erasure import ErasureCoder
from repro_torch.core.telemetry import COUNTERS, LatencyRecorder, \
    QuantileWindow

DEFAULT_STRIPE_DEADLINE_S = 0.02   # << origin RTT; a timed-out stripe is
#                                    cheaper than falling through to origin
DEFAULT_HEDGE_QUANTILE = 0.95


class LatencyModel:
    """Two components, calibrated to the paper's Fig 10/9:
    server-side service time (GET median <50us, memory tier) and
    client-observed network time (median ~450us, so client p50 ~500us).
    Lognormal bodies + occasional heavy tail."""

    def __init__(self, rng: np.random.Generator, serve_median_s: float = 42e-6,
                 net_median_s: float = 450e-6, sigma: float = 0.3,
                 tail_p: float = 0.002, tail_scale: float = 8.0):
        self.rng = rng
        self.mu_serve = np.log(serve_median_s)
        self.mu_net = np.log(net_median_s)
        self.sigma = sigma
        self.tail_p = tail_p
        self.tail_scale = tail_scale

    def _tail(self, base: float) -> float:
        if self.rng.random() < self.tail_p:
            base *= self.tail_scale * (1 + self.rng.random() * 4)
        return base

    def serve_sample(self) -> float:
        return self._tail(float(self.rng.lognormal(self.mu_serve, self.sigma)))

    def net_sample(self) -> float:
        return self._tail(float(self.rng.lognormal(self.mu_net, self.sigma)))

    def sample(self) -> float:
        return self.serve_sample() + self.net_sample()


@dataclass(frozen=True)
class FaultPlan:
    """Pluggable per-node fault state, switchable mid-flight.

    * ``healthy`` — the calibrated latency model, data served.
    * ``crashed`` — connection refused: the client learns in one net
      RTT that the node is gone; no data, no storage (writes are lost).
    * ``blackholed`` — the node never responds at all (infinite
      latency); only the client-side per-stripe deadline bounds the
      cost. Nothing is recorded server-side: there IS no response.
    * ``slow`` — degraded service: every request's serve time is
      multiplied by ``slow_mult``, and independently with probability
      ``stall_p`` the request stalls a further ``stall_mult`` (GC
      pause / IO contention mode). Per-REQUEST randomness is what makes
      hedging effective: a fresh request is an independent draw, so
      racing two cuts the stall tail — while a deterministically-dead
      node stays the erasure code's problem.
    """

    HEALTHY = "healthy"
    CRASHED = "crashed"
    BLACKHOLED = "blackholed"
    SLOW = "slow"

    kind: str = HEALTHY
    slow_mult: float = 4.0
    stall_p: float = 0.25
    stall_mult: float = 12.0

    @classmethod
    def healthy(cls) -> "FaultPlan":
        return cls(cls.HEALTHY)

    @classmethod
    def crashed(cls) -> "FaultPlan":
        return cls(cls.CRASHED)

    @classmethod
    def blackholed(cls) -> "FaultPlan":
        return cls(cls.BLACKHOLED)

    @classmethod
    def slow(cls, mult: float = 4.0, stall_p: float = 0.25,
             stall_mult: float = 12.0) -> "FaultPlan":
        return cls(cls.SLOW, slow_mult=mult, stall_p=stall_p,
                   stall_mult=stall_mult)


class CacheNode:
    """One L2 server: in-memory hot tier over a flash tier (paper: flash
    cache with ~10% memory tier), with a ``FaultPlan`` deciding how it
    answers. Fault responses sample the SAME latency model and land in
    the SAME recorders as healthy ones (no hardcoded timeout constants),
    so fault-mode benchmarks report honest latency distributions."""

    def __init__(self, name: str, mem_bytes: int, flash_bytes: int,
                 rng: np.random.Generator, latency: LatencyModel | None = None,
                 flash_extra_s: float = 120e-6):
        self.name = name
        self.mem = LRUK(mem_bytes, k=2)
        self.flash = LRUK(flash_bytes, k=2)
        self.latency = latency or LatencyModel(rng)
        self.flash_extra_s = flash_extra_s     # a flash read's extra serve
        self.fault = FaultPlan.healthy()
        self.get_lat = LatencyRecorder(f"{name}.get")
        self.put_lat = LatencyRecorder(f"{name}.put")
        # one lock per node: parallel batched fetches hit different nodes
        # concurrently but each node serves its stripes serially (and the
        # numpy Generator behind the latency model is not thread-safe)
        self._lock = threading.Lock()

    # ------------------------------------------------------------ faults
    def set_fault(self, plan: FaultPlan):
        """Switch this node's fault plan mid-flight (attribute assignment
        is atomic; in-flight requests keep the plan they read)."""
        self.fault = plan

    @property
    def failed(self) -> bool:
        """The fault plan as a flag: anything but healthy."""
        return self.fault.kind != FaultPlan.HEALTHY

    @failed.setter
    def failed(self, value: bool):
        self.fault = FaultPlan.crashed() if value else FaultPlan.healthy()

    def _serve_sample(self, plan: FaultPlan) -> float:
        serve = self.latency.serve_sample()
        if plan.kind == FaultPlan.SLOW:
            serve *= plan.slow_mult
            if self.latency.rng.random() < plan.stall_p:
                serve *= plan.stall_mult
        return serve

    def get(self, key: str, touch: bool = True):
        """Returns (client latency seconds, bytes | None); None = miss.
        Server-side service time is recorded separately (paper Fig 10).
        A blackholed node returns latency ``inf`` — it never responds;
        the client's per-stripe deadline turns that into a timeout.
        ``touch=False`` (hedged re-GETs) answers without recording an
        access: one logical read, two requests, one recency touch."""
        plan = self.fault
        if plan.kind == FaultPlan.BLACKHOLED:
            return (math.inf, None)
        with self._lock:
            if plan.kind == FaultPlan.CRASHED:
                # connection refused: one net RTT to learn the node is
                # gone, recorded through the same recorder as served
                # GETs so fault-mode benchmarks report honest latencies
                lat = self.latency.net_sample()
                self.get_lat.record(lat)
                return (lat, None)
            serve = self._serve_sample(plan)
            if touch:
                v = self.mem.get(key)
                if v is None:
                    v = self.flash.get(key)
                    if v is not None:
                        serve += self.flash_extra_s
                        self.mem.put(key, v)       # promote
            else:
                v = self.mem.peek(key)
                if v is None:
                    v = self.flash.peek(key)
                    if v is not None:
                        serve += self.flash_extra_s
            self.get_lat.record(serve)
            return (serve + self.latency.net_sample(), v)

    def remove(self, key: str):
        """Drop `key` from both tiers (tamper invalidation path)."""
        with self._lock:
            self.mem.remove(key)
            self.flash.remove(key)

    def put(self, key: str, value: bytes):
        plan = self.fault
        if plan.kind == FaultPlan.BLACKHOLED:
            return math.inf                        # write swallowed, no ack
        with self._lock:
            if plan.kind == FaultPlan.CRASHED:
                lat = self.latency.net_sample()    # refused; write lost
                self.put_lat.record(lat)
                return lat
            # PUT: write path; lognormal body only (the Rust server's p99.99
            # stays < 4x median, Fig 10) plus a small writeback mode
            serve = float(self.latency.rng.lognormal(
                self.latency.mu_serve, self.latency.sigma)) * 3.0
            if plan.kind == FaultPlan.SLOW:
                serve *= plan.slow_mult
                if self.latency.rng.random() < plan.stall_p:
                    serve *= plan.stall_mult
            if self.latency.rng.random() < 0.04:
                serve *= 2.2                   # writeback stall mode (Fig 10)
            self.flash.put(key, value)
            self.mem.put(key, value)
            self.put_lat.record(serve)
            return serve + self.latency.net_sample()


class DistributedCache:
    """The erasure-coded L2 cluster: k-of-n stripe reads with per-stripe
    deadlines, hot-key salting, and optional hedged GETs."""

    def __init__(self, num_nodes: int = 12, k: int = 4, n: int = 5,
                 mem_bytes: int = 64 << 20, flash_bytes: int = 512 << 20,
                 seed: int = 0, parity_fn=None, matmul_fn=None,
                 stripe_parallelism: int | None = None,
                 stripe_deadline_s: float = DEFAULT_STRIPE_DEADLINE_S,
                 hedge_quantile: float | None = None,
                 infection_threshold: int = 0, salt_count: int = 3,
                 hot_window: int = 4096):
        self.rng = np.random.default_rng(seed)
        self.coder = ErasureCoder(k, n, parity_fn=parity_fn,
                                  matmul_fn=matmul_fn)
        self.nodes = {f"cache-{i:03d}": CacheNode(
            f"cache-{i:03d}", mem_bytes, flash_bytes,
            np.random.default_rng(seed * 1000 + i))
            for i in range(num_nodes)}
        self.ring = HashRing(list(self.nodes), vnodes=64)
        self.fetch_lat = LatencyRecorder("l2.fetch")
        # stripe-request fan-out: wide enough to keep several chunks'
        # worth of per-node GETs in flight (stripes of one chunk go to
        # distinct nodes, so they never serialize on a node lock)
        self.stripe_parallelism = stripe_parallelism or 4 * n
        self._stripe_pool = LazyPool()
        # resilience knobs
        self.stripe_deadline_s = stripe_deadline_s
        self.hedge_quantile = hedge_quantile
        self._lat_window = QuantileWindow(maxlen=512, min_samples=32)
        # hot-key ("infected chunk") salting state
        self.hot = HotKeyTracker(infection_threshold, window=hot_window)
        self.salt_count = max(1, int(salt_count))
        self._salts: dict[str, int] = {}       # name -> live salt copies
        self._salt_rr: dict[str, int] = {}     # name -> read round-robin
        self._salting: set[str] = set()        # fan-outs in progress
        self._salt_lock = threading.Lock()

    # ---------------------------------------------------------- placement
    def _stripe_key(self, pk: str, i: int) -> str:
        return f"{pk}/s{i}"

    def _salt_key(self, name: str, j: int) -> str:
        return name if j == 0 else f"{name}#s{j}"

    def _read_placement(self, name: str) -> str:
        """The placement key this read uses: the base name, or — once the
        chunk is infected and salted — a round-robin pick over the salt
        copies, spreading the hotspot across salt_count * n nodes."""
        if self.hot.threshold <= 0:
            return name
        self.hot.record(name)
        with self._salt_lock:
            ns = self._salts.get(name, 0)
            if not ns:
                return name
            j = self._salt_rr.get(name, -1) + 1
            self._salt_rr[name] = j
            j %= ns
        if j:
            COUNTERS.inc("l2.salted_reads")
        return self._salt_key(name, j)

    def _maybe_salt(self, name: str, data: bytes):
        """Infection response on the read path: the first successful
        reconstruction of a hot-but-unsalted chunk fans its stripes out
        to the salt placements, so subsequent reads spread without
        waiting for a write. Racing readers dedup on ``_salting``; the
        salt copies only become eligible for reads once fully written."""
        if self.salt_count <= 1 or self.hot.threshold <= 0:
            return
        with self._salt_lock:
            if name in self._salts or name in self._salting \
                    or not self.hot.is_hot(name):
                return
            self._salting.add(name)
        try:
            stripes = self.coder.encode(data)
            for j in range(1, self.salt_count):
                pk = self._salt_key(name, j)
                nodes = self.ring.lookup(pk, count=self.coder.n)
                for i, node in enumerate(nodes):
                    self.nodes[node].put(self._stripe_key(pk, i), stripes[i])
                    self.ring.record_placement(node)
                COUNTERS.inc("l2.salt_fanout_puts", self.coder.n)
            with self._salt_lock:
                self._salts[name] = self.salt_count
            COUNTERS.inc("l2.salted_chunks")
        finally:
            with self._salt_lock:
                self._salting.discard(name)

    # -------------------------------------------------------- stripe GETs
    def _stripe_get(self, node: str, key: str, touch: bool = True,
                    window: bool = True):
        """One stripe GET with the per-stripe deadline applied: a
        response slower than ``stripe_deadline_s`` (a blackholed node's
        ``inf`` included) becomes a timeout — latency capped at the
        deadline, no bytes — instead of an unbounded wait."""
        lat, v = self.nodes[node].get(key, touch=touch)
        if lat > self.stripe_deadline_s:
            COUNTERS.inc("l2.stripe_timeouts")
            return (self.stripe_deadline_s, None)
        if window:
            self._lat_window.record(lat)
        return (lat, v)

    def _hedge_deadline(self, hedge: bool | None) -> float | None:
        """The hedge-trigger latency for this fetch, or None (hedging
        off / window not yet warm). ``hedge`` overrides the cache
        default per call (None = inherit)."""
        if hedge is None:
            q = self.hedge_quantile
        elif hedge:
            q = self.hedge_quantile or DEFAULT_HEDGE_QUANTILE
        else:
            q = None
        if q is None:
            return None
        d = self._lat_window.quantile(q)
        return None if math.isnan(d) else d

    def _apply_hedges(self, pk: str, resp: list, deadline_h: float):
        """Race one extra GET against every straggler past the hedge
        deadline. The hedge is issued AT the deadline, so its completion
        time is ``deadline_h + fresh_sample``; the effective stripe
        latency is whichever request answers first. A hedge may also
        recover bytes the original never delivered (timeout on a slow
        node); against crashed/blackholed nodes it fails exactly like
        the original — hedging cuts per-request tails, erasure coding
        covers dead nodes. Mutates resp entries [lat, i, v, node]."""
        for r in resp:
            if r[0] <= deadline_h:
                continue
            lat2, v2 = self._stripe_get(r[3], self._stripe_key(pk, r[1]),
                                        touch=False, window=False)
            eff = deadline_h + lat2
            COUNTERS.inc("l2.hedges")
            if r[2] is None:
                if v2 is not None:
                    COUNTERS.inc("l2.hedge_wins")
                    r[0], r[2] = eff, v2
                else:
                    r[0] = min(r[0], eff)
            elif eff < r[0]:
                COUNTERS.inc("l2.hedge_wins")
                r[0] = eff

    def _account_stripes(self, pk: str, resp: list,
                         deadline_h: float | None):
        """Post-wave accounting for one chunk: hedge stragglers, then
        return (latency_s, {stripe_index: bytes} | None). Latency is the
        k-th fastest effective arrival on a hit, the worst response on a
        miss."""
        k = self.coder.k
        if deadline_h is not None:
            self._apply_hedges(pk, resp, deadline_h)
        hits = sorted((r for r in resp if r[2] is not None),
                      key=lambda r: (r[0], r[1]))
        if len(hits) < k:
            return (max((r[0] for r in resp), default=0.0), None)
        return (hits[k - 1][0], {r[1]: r[2] for r in hits[:k]})

    # --------------------------------------------------------- public API
    def put_chunk(self, name: str, data: bytes) -> float:
        stripes = self.coder.encode(data)
        with self._salt_lock:
            ns = self._salts.get(name, 0)
        if not ns and self.salt_count > 1 and self.hot.is_hot(name):
            # a write to an infected chunk salts it immediately
            ns = self.salt_count
            with self._salt_lock:
                self._salts[name] = ns
            COUNTERS.inc("l2.salted_chunks")
        lat = 0.0
        for j in range(max(1, ns)):            # writes fan out to all salts
            pk = self._salt_key(name, j)
            nodes = self.ring.lookup(pk, count=self.coder.n)
            for i, node in enumerate(nodes):
                plat = self.nodes[node].put(self._stripe_key(pk, i),
                                            stripes[i])
                lat = max(lat, min(plat, self.stripe_deadline_s))
                self.ring.record_placement(node)
            if j:
                COUNTERS.inc("l2.salt_fanout_puts", self.coder.n)
        return lat

    def get_chunk(self, name: str, chunk_len: int):
        """Constant-work fetch: n parallel stripe requests (threaded per
        node), reconstruct from the first k arrivals. Returns
        (latency_s, bytes | None)."""
        return self.get_chunks([name], chunk_len)[name]

    def get_chunks(self, names: list, chunk_len: int,
                   on_ready=None, hedge: bool | None = None) -> dict:
        """Batched constant-work fetch: every name's n stripe GETs go
        through the shared pool in ONE wave — per-node service time of
        one chunk's stripes overlaps both its siblings' and other
        chunks' — and every hit is reconstructed through ONE
        ``decode_many`` call. Per name the work is unchanged: always n
        requests, any k reconstruct, latency = k-th fastest arrival
        (plus any hedges, which are counted in ``l2.hedges``).
        Returns {name: (latency_s, bytes | None)}.

        ``on_ready(name, latency_s, data)`` switches to STREAMING
        reconstruction: each chunk is rebuilt and handed to the callback
        the moment its k-th stripe lands (per-chunk ``decode``), feeding
        the streamed read path instead of a terminal dict. The work per
        name is unchanged (still n requests issued up front — the
        constant-work property holds); the reported latency is the
        worst of the k earliest-arriving hits.

        ``hedge`` overrides the cache-level hedging default for this
        call (None = inherit ``hedge_quantile``)."""
        k, n = self.coder.k, self.coder.n
        names = list(dict.fromkeys(names))   # dedup: one wave per name
        deadline_h = self._hedge_deadline(hedge)
        pool = self._stripe_pool.get(self.stripe_parallelism)
        fut_meta = {}
        placement = {}
        for name in names:
            pk = self._read_placement(name)
            placement[name] = pk
            nodes = self.ring.lookup(pk, count=n)
            for i, node in enumerate(nodes):
                fut_meta[pool.submit(
                    self._stripe_get, node,
                    self._stripe_key(pk, i))] = (name, i, node)
        responses: dict[str, list] = {name: [] for name in names}
        out: dict = {}
        if on_ready is not None:
            # streaming mode: process stripe arrivals as they complete
            done_count = {name: 0 for name in names}
            emitted: set = set()
            pending = set(fut_meta)
            while pending:
                done, pending = wait(pending, return_when=FIRST_COMPLETED)
                for fut in done:
                    name, i, node = fut_meta[fut]
                    lat, v = fut.result()
                    done_count[name] += 1
                    resp = responses[name]
                    resp.append([lat, i, v, node])
                    if name in emitted:
                        continue
                    nhits = sum(1 for r in resp if r[2] is not None)
                    if nhits < k and done_count[name] < n:
                        continue
                    # k value-bearing stripes landed (or the wave is
                    # done): hedge stragglers, reconstruct, emit
                    lat_c, stripes = self._account_stripes(
                        placement[name], resp, deadline_h)
                    if stripes is not None:
                        emitted.add(name)
                        data = self.coder.decode(stripes, chunk_len)
                        COUNTERS.inc("l2.hits")
                        self.fetch_lat.record(lat_c)
                        out[name] = (lat_c, data)
                        self._maybe_salt(name, data)
                        on_ready(name, lat_c, data)
                    elif done_count[name] == n:
                        emitted.add(name)
                        COUNTERS.inc("l2.misses")
                        out[name] = (lat_c, None)
            return out
        for fut, (name, i, node) in fut_meta.items():
            lat, v = fut.result()
            responses[name].append([lat, i, v, node])
        hits, stripes_list, lens = [], [], []
        for name in names:
            lat_c, stripes = self._account_stripes(
                placement[name], responses[name], deadline_h)
            if stripes is None:
                COUNTERS.inc("l2.misses")
                out[name] = (lat_c, None)
            else:
                hits.append((name, lat_c))   # k-th fastest completes
                stripes_list.append(stripes)
                lens.append(chunk_len)
        if hits:
            datas = self.coder.decode_many(stripes_list, lens)
            for (name, lat), data in zip(hits, datas):
                COUNTERS.inc("l2.hits")
                self.fetch_lat.record(lat)
                out[name] = (lat, data)
                self._maybe_salt(name, data)
        return out

    def invalidate(self, name: str):
        """Drop every stripe of `name` — base placement AND every salt
        copy — from every placement node (the reader calls this when a
        reconstructed chunk fails its integrity check, so a retry goes
        back to origin instead of replaying the bad bytes)."""
        with self._salt_lock:
            ns = self._salts.pop(name, 0)
            self._salt_rr.pop(name, None)
        for j in range(max(1, ns)):
            pk = self._salt_key(name, j)
            nodes = self.ring.lookup(pk, count=self.coder.n)
            for i, node in enumerate(nodes):
                self.nodes[node].remove(self._stripe_key(pk, i))

    def get_chunk_unreplicated(self, name: str, chunk_len: int):
        """Fig. 9's comparison: a k-of-k read of the k data stripes, one
        after another, with no parity to fall back on. Returns (latency
        of the slowest of the k, bytes | None)."""
        k = self.coder.k
        nodes = self.ring.lookup(name, count=self.coder.n)
        lats, stripes = [], {}
        for i, node in enumerate(nodes[:k]):
            lat, v = self._stripe_get(node, self._stripe_key(name, i),
                                      window=False)
            lats.append(lat)
            if v is not None:
                stripes[i] = v
        if len(stripes) < k:
            return (max(lats), None)
        return (max(lats), self.coder.decode(stripes, chunk_len))

    # ------------------------------------------------------ fault control
    def set_fault(self, name: str, plan: FaultPlan):
        """Switch one node's fault plan mid-flight (in-flight stripe
        GETs keep the plan they read; the next wave sees the new one)."""
        self.nodes[name].set_fault(plan)

    def fail_node(self, name: str, failed: bool = True):
        """Crash (or, with ``failed=False``, heal) one node."""
        self.nodes[name].set_fault(
            FaultPlan.crashed() if failed else FaultPlan.healthy())

    def flush(self):
        """Empty every node's tiers and forget every salt copy."""
        for node in self.nodes.values():
            node.mem = LRUK(node.mem.capacity, k=2)
            node.flash = LRUK(node.flash.capacity, k=2)
        with self._salt_lock:
            self._salts.clear()
            self._salt_rr.clear()

    @property
    def hit_rate(self) -> float:
        """``l2.hits`` over hits and misses, process-wide."""
        h = COUNTERS.get("l2.hits")
        m = COUNTERS.get("l2.misses")
        return h / max(1.0, h + m)
