"""ImageService: the process-wide read-path agent (the port of
``repro.core.service``).

* ``ServiceConfig`` — the knobs the port uses, with the JAX package's
  names and defaults, except that ``decode_backend`` defaults to
  ``"torch-fused"`` and there is a ``device`` (default ``"cuda"``;
  constructing a config for CUDA on a machine without it raises). The
  peer, retry and breaker knobs are all off by default. The decode
  pool: ``decode_backend``, ``max_batch_bytes`` (``"auto"`` autotunes
  per backend, ``core.decode.autotune_tile_bytes``), ``decode_threads``
  and ``eager_min_bytes``; ``session_cap`` and ``session_ttl_s`` bound
  the session and parsed-manifest caches.
* ``ImageService`` — shared store, L1, L2, admission and fetch limiters,
  decoder pools, single-flight table, and one ``RetryPolicy`` and one
  ``CircuitBreaker`` shared by its readers and its publisher; ``open``
  hands out ``ImageHandle`` sessions, ``publish`` runs the write path.
  The L2 is either passed in (``ImageService(store, cfg, l2=...)``, one
  L2 shared by several workers) or built from ``l2_nodes`` > 0, with the
  erasure kernels of the service's device as its hooks. The peer tier
  is passed in as this worker's client of a mesh that spans many
  services (``build_peer_mesh``, ``ImageService(..., peer=...)``).
  With the GC's ``RootPinRegistry`` and ``RefcountIndex``
  (``ImageService(..., pins=, refcounts=)``) every reader pins its root
  while it reads and the publisher registers each image it seals.
* ``ImageHandle`` — reads of one opened image under a ``ReadPolicy``:
  whole trees, shards, and prefetches that only warm the tiers.
* ``single_image_service`` — a private service with no tiers of its
  own, the substrate of ``core.loader.ImageReader``.
"""
from __future__ import annotations

import contextlib
import hashlib
import itertools
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.blockdev import (
    DEFAULT_PARALLELISM,
    DEFAULT_QUEUE_DEPTH,
    FlightTable,
    TieredReader,
)
from repro_torch.core.cache.distributed import DistributedCache
from repro_torch.core.cache.local import LocalCache
from repro_torch.core.cache.peer import PeerMesh
from repro_torch.core.concurrency import BlockingLimiter, RejectingLimiter
from repro_torch.core.decode import (
    DEFAULT_EAGER_MIN_BYTES,
    BatchDecoder,
    known_backend_names,
    resolve_backend_name,
)
from repro_torch.core.layout import (
    CHUNK_SIZE,
    ImageLayout,
    array_from_bytes,
    ranges_to_chunks,
    read_tensor,
    shard_byte_ranges,
)
from repro_torch.core.manifest import open_manifest
from repro_torch.core.publish import PublishPipeline
from repro_torch.core.retry import CircuitBreaker, RetryPolicy
from repro_torch.core.telemetry import COUNTERS, ScopedCounters
from repro_torch.kernels.gf256.ops import rs_matmul_fn
from repro_torch.kernels.parity.ops import parity_fn_for_erasure

_MODES = ("streamed", "staged", "serial")


class ColdStartRejected(RuntimeError):
    """Admission control turned the cold start away (paper §4.2:
    excess starts are rejected, not queued). ``retry_after_s`` > 0
    means the brownout shed it (the origin breaker is open) and says
    when the breaker next accepts probes."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclass(frozen=True)
class ReadPolicy:
    """How ONE read runs. ``mode``: ``"streamed"`` (default; decode
    overlaps fetch), ``"staged"`` (fetch, then decode) or ``"serial"``
    (per-chunk oracle). ``parallelism`` is the origin fetch width;
    ``max_batch_bytes`` and ``decode_backend`` override the service's
    decode tile and backend (``None`` inherits; an explicit tile wins
    over the autotuner); ``queue_depth`` bounds the streamed hand-off
    queue. ``eager_flush``: decode the partial tile whenever the
    streamed consumer would block on the hand-off queue;
    ``eager_min_bytes``: the least partial tile such a flush may
    dispatch. ``l2_hedge``: hedged stripe GETs in the L2 for this read
    (forwarded only when the L2 supports hedging). The last three are
    tri-state: ``None`` inherits the service's (or the cache's)
    default, ``True``/``False`` or a number override it."""

    mode: str = "streamed"
    parallelism: int = DEFAULT_PARALLELISM
    max_batch_bytes: int | None = None
    decode_backend: str | None = None
    queue_depth: int = DEFAULT_QUEUE_DEPTH
    eager_flush: bool | None = None
    eager_min_bytes: int | None = None
    l2_hedge: bool | None = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"ReadPolicy.mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if self.decode_backend is not None and \
                self.decode_backend not in known_backend_names():
            raise ValueError(f"unknown decode_backend "
                             f"{self.decode_backend!r}; known: "
                             f"{known_backend_names()}")
        if self.parallelism < 1:
            raise ValueError("parallelism must be >= 1")

    @classmethod
    def from_legacy(cls, *, batched: bool = True, streamed: bool = True,
                    parallelism: int = DEFAULT_PARALLELISM) -> "ReadPolicy":
        """The policy of the legacy ``batched=/streamed=/parallelism=``
        keywords (the ``ImageReader`` shim)."""
        mode = "serial" if not batched else ("streamed" if streamed
                                             else "staged")
        return cls(mode=mode, parallelism=parallelism)

    @property
    def streamed(self) -> bool:
        return self.mode == "streamed"


@dataclass
class ServiceConfig:
    """Process-wide read-path configuration (module doc). ``l1_bytes=0``
    disables the L1, ``l2_nodes=0`` the L2, ``max_coldstarts=0``
    admission control and ``fetch_concurrency=0`` the origin limiter.
    The ``l2_*`` knobs size the L2 the service builds itself (``None``
    keeps the cache's default)."""

    l1_bytes: int = 256 << 20
    l2_nodes: int = 0                   # 0 = no L2 tier
    l2_seed: int = 0
    l2_mem_bytes: int | None = None
    l2_flash_bytes: int | None = None
    max_coldstarts: int = 4             # admission control (§4.2)
    fetch_concurrency: int = 16         # 0 = unbounded origin reads
    decode_backend: str = "torch-fused"  # publish too, unless publish_backend
    decode_threads: int | None = None   # None = the decoder's default
    # "auto" = per-backend autotuned tile (decode.autotune_tile_bytes: a
    # timed sweep at first use, cached per process); any explicit int,
    # here or per read in ReadPolicy.max_batch_bytes, wins
    max_batch_bytes: int | str = "auto"
    eager_min_bytes: int = DEFAULT_EAGER_MIN_BYTES
    session_cap: int = 64               # LRU session bound (0 = unbounded)
    session_ttl_s: float | None = None  # None = no idle expiry
    manifest_cap: int = 128             # LRU manifest bound (0 = unbounded)
    origin_delay_s: float = 0.0         # simulated origin RTT per GET
    root: str | None = None             # default root for open()/publish()
    default_policy: ReadPolicy = field(default_factory=ReadPolicy)
    device: str = "cuda"
    # L2 resilience knobs (only used when the service builds its own L2)
    l2_stripe_deadline_s: float | None = None   # None = cache default
    l2_hedge_quantile: float | None = None      # None = hedging off
    l2_infection_threshold: int = 0             # 0 = hot-key salting off
    l2_salt_count: int = 3                      # placement keys when salted
    # peer-tier knobs (used by build_peer_mesh: the mesh spans many
    # services, so a service receives its PeerClient via peer=)
    peer_fanout: int = 4                # provisioning-tree arity
    peer_deadline_s: float = 2.0        # bounded wait on a joined flight
    peer_registration: str = "all"      # "all" | "origin" (see peer.py)
    # publish-side knobs (the write path: ``core.publish.PublishPipeline``
    # built lazily by ``ImageService.publisher``)
    publish_backend: str | None = None  # None = decode_backend
    publish_tile_bytes: int | str | None = None  # None = backend default
    upload_parallelism: int = 8         # bounded-parallel PUTs per service
    publish_warm_l1: bool = True        # push fresh ciphertexts into L1/peer
    # sidecar file of the publish NameIndex (skip-encryption dedup
    # survives restarts); None = in memory only
    publish_name_index_path: str | None = None
    # origin-tier resilience (core.retry / core.faults), all off by
    # default
    retry_attempts: int = 0             # total origin attempts; 0/1 = off
    retry_base_s: float = 0.01          # backoff floor (decorrelated jitter)
    retry_cap_s: float = 0.5            # backoff ceiling
    retry_total_budget_s: float | None = None   # wall budget across attempts
    retry_attempt_timeout_s: float | None = None  # per-attempt deadline
    retry_integrity_refetches: int = 2  # evict+refetch rounds on bad bytes
    retry_seed: int | None = None       # pin the jitter stream
    breaker_threshold: float | None = None  # error rate to open; None = off
    breaker_window: int = 64            # sliding error-rate window size
    breaker_min_samples: int = 10       # samples before the rate can trip
    breaker_cooldown_s: float = 1.0     # open -> half-open delay
    breaker_half_open_probes: int = 1   # concurrent probes while half-open
    breaker_shed_coldstarts: bool = True  # brownout: shed admissions too

    def __post_init__(self):
        resolve_device(self.device)
        resolve_backend_name(self.decode_backend)
        if self.publish_backend is not None:
            resolve_backend_name(self.publish_backend)


_SVC_SEQ = itertools.count()


class ImageService:
    """Process-wide agent: construct once, ``open()`` per image."""

    def __init__(self, store, config: ServiceConfig | None = None, *,
                 l1=None, l2=None, peer=None, fetch_limiter=None,
                 admission=None, counters=None, pins=None, refcounts=None):
        cfg = config if config is not None else ServiceConfig()
        self.config = cfg
        self.device = resolve_device(cfg.device)
        self.store = store
        # a unique telemetry name per service: LocalCache keys its
        # hit/miss counters off it
        if l1 is not None:
            self.l1 = l1
        else:
            self.l1 = LocalCache(cfg.l1_bytes,
                                 name=f"svc{next(_SVC_SEQ)}.l1") \
                if cfg.l1_bytes > 0 else None
        self.l2 = l2 if l2 is not None else self._build_l2(cfg)
        self.peer = peer
        if fetch_limiter is not None:
            self.fetch_limiter = fetch_limiter
        else:
            self.fetch_limiter = BlockingLimiter(cfg.fetch_concurrency) \
                if cfg.fetch_concurrency > 0 else None
        if admission is not None:
            self.admission = admission
        else:
            self.admission = RejectingLimiter(cfg.max_coldstarts) \
                if cfg.max_coldstarts > 0 else None
        # a Counters-compatible sink (``COUNTERS`` by default): the
        # breaker and the tenant scopes count through it
        self.counters = counters if counters is not None else COUNTERS
        # one retry policy and one breaker per service, shared by every
        # reader and the publisher: the breaker's error rate must span
        # all of this process's origin traffic
        self.retry = RetryPolicy(
            attempts=cfg.retry_attempts, base_s=cfg.retry_base_s,
            cap_s=cfg.retry_cap_s, total_budget_s=cfg.retry_total_budget_s,
            attempt_timeout_s=cfg.retry_attempt_timeout_s,
            integrity_refetches=cfg.retry_integrity_refetches,
            seed=cfg.retry_seed) if cfg.retry_attempts > 1 else None
        self.breaker = CircuitBreaker(
            cfg.breaker_threshold, window=cfg.breaker_window,
            min_samples=cfg.breaker_min_samples,
            cooldown_s=cfg.breaker_cooldown_s,
            half_open_probes=cfg.breaker_half_open_probes,
            counters=self.counters) \
            if cfg.breaker_threshold is not None else None
        self.flights = FlightTable()
        # GC integration (both optional; wire the same objects into the
        # ``GenerationalGC``): readers pin their root while they read,
        # and the publisher registers each image it seals
        self.pins = pins
        self.refcounts = refcounts
        self._publisher: PublishPipeline | None = None
        self._decoders: dict[tuple, BatchDecoder] = {}
        self._scopes: dict[str, ScopedCounters] = {}
        self._sessions: OrderedDict = OrderedDict()
        self._manifests: OrderedDict = OrderedDict()
        self._closed = False
        self._lock = threading.Lock()

    # ------------------------------------------------------------ plumbing
    def _build_l2(self, cfg: ServiceConfig):
        """The L2 of ``l2_nodes`` nodes, its erasure coder running the
        parity and GF(256) kernels on this service's device (their
        plain versions on the CPU); None for ``l2_nodes=0``."""
        if cfg.l2_nodes <= 0:
            return None
        kw = {}
        if cfg.l2_mem_bytes is not None:
            kw["mem_bytes"] = cfg.l2_mem_bytes
        if cfg.l2_flash_bytes is not None:
            kw["flash_bytes"] = cfg.l2_flash_bytes
        if cfg.l2_stripe_deadline_s is not None:
            kw["stripe_deadline_s"] = cfg.l2_stripe_deadline_s
        return DistributedCache(
            num_nodes=cfg.l2_nodes, seed=cfg.l2_seed,
            parity_fn=parity_fn_for_erasure(self.device),
            matmul_fn=rs_matmul_fn(self.device),
            hedge_quantile=cfg.l2_hedge_quantile,
            infection_threshold=cfg.l2_infection_threshold,
            salt_count=cfg.l2_salt_count, **kw)

    def decoder_for(self, policy: ReadPolicy) -> BatchDecoder:
        """The shared ``BatchDecoder`` of `policy`'s decode knobs: one
        per (backend, tile, eager, eager_min_bytes), keyed by the
        canonical backend name so aliases share a pool."""
        cfg = self.config
        eager = policy.eager_flush if policy.eager_flush is not None \
            else bool(cfg.default_policy.eager_flush)
        backend = policy.decode_backend or cfg.decode_backend
        key = (resolve_backend_name(backend),
               policy.max_batch_bytes or cfg.max_batch_bytes,
               eager,
               policy.eager_min_bytes if policy.eager_min_bytes is not None
               else cfg.eager_min_bytes)
        with self._lock:
            dec = self._decoders.get(key)
            if dec is None:
                dec = BatchDecoder(backend, max_batch_bytes=key[1],
                                   threads=cfg.decode_threads,
                                   eager_flush=key[2],
                                   eager_min_bytes=key[3],
                                   device=self.device)
                # a closed service hands out uncached decoders
                if not self._closed:
                    self._decoders[key] = dec
            return dec

    def tenant_counters(self, tenant: str) -> ScopedCounters:
        """The per-tenant telemetry scope (updates land in both the
        global counters and ``tenant.<t>::<name>``)."""
        with self._lock:
            sc = self._scopes.get(tenant)
            if sc is None:
                sc = self._scopes[tenant] = self.counters.scope(
                    f"tenant.{tenant}")
            return sc

    def _cached(self, cache: OrderedDict, key, cap: int, counter: str,
                build):
        """LRU+TTL get-or-build (caller does NOT hold the lock). An
        entry idle past ``session_ttl_s`` expires on lookup, and every
        insert sweeps the idle entries and then the least recently used
        beyond `cap`; each expiry or eviction ticks `counter`. A closed
        service caches nothing."""
        ttl = self.config.session_ttl_s
        with self._lock:
            entry = cache.get(key)
            if entry is not None:
                now = time.monotonic()
                if ttl is not None and now - entry[1] > ttl:
                    del cache[key]
                    self.counters.inc(counter)
                else:
                    entry[1] = now
                    cache.move_to_end(key)
                    return entry[0]
        value = build()
        with self._lock:
            if self._closed:
                return value
            now = time.monotonic()
            entry = cache.setdefault(key, [value, now])
            entry[1] = now
            cache.move_to_end(key)
            if ttl is not None:
                for k in [k for k, v in cache.items() if now - v[1] > ttl]:
                    del cache[k]
                    self.counters.inc(counter)
            while cap > 0 and len(cache) > cap:
                cache.popitem(last=False)
                self.counters.inc(counter)
            return entry[0]

    def close(self):
        """Drop cached sessions and manifests, drain decoder pools and
        the publisher. Live handles keep reading; ``open`` raises.
        Idempotent."""
        with self._lock:
            self._closed = True
            decoders = list(self._decoders.values())
            self._decoders.clear()
            self._sessions.clear()
            self._manifests.clear()
            publisher, self._publisher = self._publisher, None
        for dec in decoders:
            dec.close()
        if publisher is not None:
            publisher.close()

    @contextlib.contextmanager
    def admission_slot(self):
        """Hold one admission slot; raises ``ColdStartRejected`` when
        ``max_coldstarts`` starts are in flight (reject, don't queue) or,
        the brownout's first rung, when the origin breaker is open (with
        a ``retry_after_s`` hint). Half-open probing is left to reads in
        flight, so recovery does not wait for new arrivals."""
        br = self.breaker
        lim = self.admission
        if br is not None and self.config.breaker_shed_coldstarts \
                and br.state == CircuitBreaker.OPEN:
            ra = br.retry_after_s()
            self.counters.inc("serve.brownout_shed")
            if lim is not None:
                lim.shed()
            raise ColdStartRejected(
                f"cold-start shed: origin breaker open (retry after "
                f"{ra:.2f}s)", retry_after_s=ra)
        if lim is None:
            yield
            return
        if not lim.try_acquire():
            self.counters.inc("serve.coldstart_rejected")
            raise ColdStartRejected("cold-start rejected: concurrency limit")
        try:
            yield
        finally:
            lim.release()

    # -------------------------------------------------------------- open
    def open(self, manifest_blob: bytes, tenant_key: bytes, *,
             root: str | None = None, tenant: str | None = None,
             decoder: BatchDecoder | None = None) -> "ImageHandle":
        """Open an image session. `root` is the root the manifest was
        fetched from (default: the config root, then the manifest's;
        after a GC migration it differs from the manifest's, which names
        the root whose salt the chunks carry); `tenant` defaults to the
        manifest's. Handles of the same (image, root, tenant) share one
        ``TieredReader``; a caller-owned `decoder` gets a reader of its
        own, which is not cached."""
        if self._closed:
            raise RuntimeError("ImageService is closed")

        def parse():
            m = open_manifest(manifest_blob, tenant_key)
            return m, ImageLayout.from_table(m.layout_table, m.chunk_size)

        manifest, layout = self._cached(
            self._manifests, (hashlib.sha256(manifest_blob).digest(),
                              tenant_key), self.config.manifest_cap,
            "service.manifest_evictions", parse)
        root = root or self.config.root or manifest.root_id
        tenant = tenant if tenant is not None else manifest.tenant

        def session():
            scope = self.tenant_counters(tenant)
            reader = TieredReader(
                manifest, self.store, root=root, l1=self.l1, l2=self.l2,
                concurrency=self.fetch_limiter,
                origin_delay_s=self.config.origin_delay_s,
                decoder=decoder if decoder is not None
                else self.decoder_for(self.config.default_policy),
                counters=scope, flights=self.flights, peer=self.peer,
                pins=self.pins, retry=self.retry, breaker=self.breaker)
            return reader, scope

        if decoder is not None:
            reader, scope = session()
            return ImageHandle(self, manifest, layout, reader, tenant, scope)
        reader, scope = self._cached(
            self._sessions, (manifest.image_id, root, tenant),
            self.config.session_cap, "service.session_evictions", session)
        return ImageHandle(self, manifest, layout, reader, tenant, scope)

    # ------------------------------------------------------------- publish
    def publisher(self) -> PublishPipeline:
        """The service's shared write path (lazily built): the publish
        backend's hooks on the service's device, bounded-parallel
        single-flighted uploads under the service's retry policy, the
        name index (with its sidecar file when the config names one),
        the refcounts when the service carries them, and
        (``publish_warm_l1``) the fresh ciphertexts pushed into this
        service's L1 and peer tier."""
        with self._lock:
            if self._publisher is None:
                cfg = self.config
                warm = cfg.publish_warm_l1
                self._publisher = PublishPipeline(
                    self.store,
                    backend=cfg.publish_backend or cfg.decode_backend,
                    tile_bytes=cfg.publish_tile_bytes,
                    upload_parallelism=cfg.upload_parallelism,
                    l1=self.l1 if warm else None,
                    peer=self.peer if warm else None,
                    refcounts=self.refcounts, counters=self.counters,
                    retry=self.retry,
                    name_index_path=cfg.publish_name_index_path,
                    device=self.device)
            return self._publisher

    def publish(self, tree, *, tenant: str, tenant_key: bytes,
                root: str | None = None, salt_epoch: int = 0,
                image_id: str | None = None,
                chunk_size: int = CHUNK_SIZE) -> tuple:
        """Publish a tree of arrays as an image: (manifest blob,
        CreateStats)."""
        if self._closed:
            raise RuntimeError("ImageService is closed")
        root = root or self.config.root
        if root is None:
            raise ValueError("publish needs a root (or ServiceConfig.root)")
        return self.publisher().publish(
            tree, tenant=tenant, tenant_key=tenant_key, root=root,
            salt_epoch=salt_epoch, image_id=image_id, chunk_size=chunk_size)

    def snapshot(self) -> dict:
        return self.counters.snapshot()


class ImageHandle:
    """A session over one opened image."""

    def __init__(self, service: ImageService, manifest, layout: ImageLayout,
                 reader: TieredReader, tenant: str, scope: ScopedCounters):
        self.service = service
        self.manifest = manifest
        self.layout = layout
        self.reader = reader
        self.tenant = tenant
        self.counters = scope

    def _resolve(self, policy: ReadPolicy | None) -> tuple:
        """(policy, decoder) with the service defaults applied. A policy
        with no decode override keeps the handle's bound decoder (the
        caller's, when the session was opened with ``decoder=``); an
        explicit ``eager_flush=True/False`` is an override."""
        p = policy if policy is not None \
            else self.service.config.default_policy
        if p.decode_backend is None and p.max_batch_bytes is None \
                and p.eager_flush is None and p.eager_min_bytes is None:
            return p, self.reader.decoder
        return p, self.service.decoder_for(p)

    def tensor_names(self) -> list:
        return list(self.layout.tensors)

    def tensor(self, name: str) -> np.ndarray:
        """Serial restore of one tensor (the reference read path)."""
        return read_tensor(self.layout, name, self.reader.read)

    def restore_tree(self, names=None,
                     policy: ReadPolicy | None = None) -> dict:
        """Flat {path: array} for all (or selected) tensors, through one
        pipelined batch shaped by `policy`."""
        names = names if names is not None else self.tensor_names()
        return self.restore_shards({n: None for n in names}, policy)

    def restore_shards(self, shard_slices: dict,
                       policy: ReadPolicy | None = None) -> dict:
        """Batched restore of {name: dim_slices | None (full tensor)}:
        every byte range computed up front, the union chunk set fetched
        once, then each tensor or shard assembled."""
        p, dec = self._resolve(policy)
        plan = []
        all_ranges = []
        for name, sl in shard_slices.items():
            t = self.layout.tensors[name]
            if not t.shape or sl is None:
                ranges, shape = [(t.offset, t.nbytes)], t.shape
            else:
                ranges = shard_byte_ranges(t, sl)
                shape = tuple(e - s for s, e in sl)
            plan.append((name, ranges, shape, t.dtype))
            all_ranges.extend(ranges)
        if p.mode == "serial":
            bufs = iter([self.reader.read(off, ln) for off, ln in all_ranges])
        else:
            bufs = iter(self.reader.read_many(
                all_ranges, p.parallelism, streamed=p.streamed,
                queue_depth=p.queue_depth, decoder=dec,
                l2_hedge=p.l2_hedge))
        out = {}
        for name, ranges, shape, dt in plan:
            raw = b"".join(next(bufs) for _ in ranges)
            out[name] = array_from_bytes(raw, dt, shape)
        return out

    def tensor_shard(self, name: str, dim_slices: list,
                     policy: ReadPolicy | None = None) -> np.ndarray:
        """Fetch only the bytes of one rectangular shard (batched)."""
        return self.restore_shards({name: dim_slices}, policy)[name]

    def shard_chunks(self, shard_slices: dict) -> list:
        """Chunk indices needed for {tensor_name: [(start, stop) per dim]}."""
        ranges = []
        for name, sl in shard_slices.items():
            ranges.extend(shard_byte_ranges(self.layout.tensors[name], sl))
        return ranges_to_chunks(ranges, self.manifest.chunk_size)

    def prefetch(self, chunk_indices: list,
                 policy: ReadPolicy | None = None):
        """Warm the tiers for `chunk_indices` without decoding: the
        ciphertexts land in L1 (and L2, peers), none is decrypted. A
        streamed policy (the default) warms through the streaming
        producer, the path the streamed restore takes."""
        p, _ = self._resolve(policy)
        self.reader.fetch_chunks(chunk_indices, p.parallelism,
                                 materialize=False, streamed=p.streamed,
                                 queue_depth=p.queue_depth,
                                 l2_hedge=p.l2_hedge)


def single_image_service(store, *, l1=None, l2=None, peer=None,
                         fetch_limiter=None, origin_delay_s: float = 0.0,
                         device="cuda") -> ImageService:
    """A private service with no tiers or limiters of its own (only the
    objects passed in): the substrate of the ``ImageReader`` shim and of
    one-shot scripts."""
    cfg = ServiceConfig(l1_bytes=0, l2_nodes=0, fetch_concurrency=0,
                        max_coldstarts=0, origin_delay_s=origin_delay_s,
                        device=device)
    return ImageService(store, cfg, l1=l1, l2=l2, peer=peer,
                        fetch_limiter=fetch_limiter)


def build_peer_mesh(config: ServiceConfig, num_workers: int, *,
                    seed: int = 0, transfer_hook=None) -> PeerMesh:
    """A ``PeerMesh`` sized from `config`'s peer knobs. Worker i's
    service takes ``mesh.client(i)`` (``ImageService(peer=...)``);
    faults go through ``mesh.set_fault(i, FaultPlan...)`` as for the
    L2's nodes."""
    return PeerMesh(num_workers, fanout=config.peer_fanout,
                    deadline_s=config.peer_deadline_s,
                    registration=config.peer_registration,
                    seed=seed, transfer_hook=transfer_hook)
