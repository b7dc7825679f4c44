"""Peer-to-peer provisioning tier for cold-start storms (FaaSNet-style;
copy of ``repro.core.cache.peer``, same names, defaults, counters and
per-worker RNG seeding, so the two meshes draw the same latencies).

In a cold-start storm N workers start the same image at once; each
worker's caches dedup only within its own process, so origin traffic is
origin x workers. Workers instead fetch chunks from each other through
a provisioning tree.

This module simulates that mesh in one process:

* ``PeerMesh`` — the shared fabric of an N-worker fleet: a **chunk
  directory** (content-addressed name -> worker ids holding the
  ciphertext), a table of **provisioning flights** (one per chunk name
  currently being pulled from the lower tiers by some worker), and one
  ``_Worker`` record per worker (its registered ciphertexts, its
  ``FaultPlan`` — the same machinery the L2 nodes use — and its peer
  transfer latency model).
* ``PeerClient`` — one worker's view of the mesh, duck-typed alongside
  ``LocalCache``/``DistributedCache`` so ``TieredReader`` can probe it
  as an ordinary tier (probe order: L1 -> peer -> L2 -> origin).

How a cold-start storm resolves through the tier:

1. The FIRST worker to miss a chunk claims the chunk's provisioning
   flight (``peer.misses`` ticks) and falls through to L2/origin like
   today. When its fetch lands, ``put_chunk`` resolves the flight and
   registers the worker in the directory.
2. Every LATER worker joins the flight instead of fetching: joiners are
   positions in a ``fanout``-ary provisioning tree rooted at the
   leader, and when the flight resolves each joiner "receives" the
   chunk through its tree path — simulated latency is one peer-RTT
   sample per tree edge on the path, so deep joiners honestly pay
   log_fanout(N) hops. Joiners register themselves too (policy
   ``"all"``), so later direct lookups spread over the whole subtree.
3. A worker that misses AFTER the flight resolved finds holders in the
   directory and transfers directly from one (one RTT).

Failure semantics — peer death must fall through, never corrupt:

* Every transfer checks the serving worker's ``FaultPlan`` at serve
  time. A crashed/blackholed parent (or any faulted ANCESTOR on the
  joiner's tree path — the whole subtree is orphaned) fails that
  joiner's peer fetch; the joiner first retries a direct transfer from
  any healthy registered holder, and only then reports a miss so its
  reader falls through to L2/origin. Bytes always re-verify through
  the convergent SHA check, so a fall-through can never diverge.
* A leader that dies mid-fetch (its reader errors) calls ``abandon``:
  the first joiner is PROMOTED to leader — it wakes, reports a miss,
  and ITS reader falls through to origin, later resolving the flight
  for the remaining joiners. One death costs one extra origin GET, not
  a waiter stampede.
* Every join is deadline-bounded (``deadline_s``): a wedged flight
  costs a bounded wait, then a fall-through.

Registration policy (``registration``):

* ``"all"`` (default) — workers register chunks acquired from ANY
  tier: origin fetches, L2 hits, and peer transfers. The provisioning
  tree compounds (every served joiner becomes a future server).
* ``"origin"`` — only origin-fetchers register. The directory stays
  minimal; transfer load concentrates on tree roots (the FaaSNet
  baseline without subtree re-serving).

Everything is ciphertext: the tier moves the same content-addressed
encrypted chunks L1/L2 move, so byte identity to the serial oracle is
preserved by construction and tamper still surfaces as an
``IntegrityError`` in the reader's decode stage (which then calls
``invalidate`` here too, dropping the bad name from the directory and
every holder).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np

from repro_torch.core.cache.distributed import FaultPlan, LatencyModel
from repro_torch.core.concurrency import LazyPool
from repro_torch.core.telemetry import COUNTERS

DEFAULT_PEER_FANOUT = 4
DEFAULT_PEER_DEADLINE_S = 2.0
REGISTRATION_POLICIES = ("all", "origin")


class _Worker:
    """One simulated worker's mesh-visible state: the ciphertexts it has
    registered, its fault plan, and its peer-transfer latency model.
    ``chunks`` is the worker's serving copy — in a real fleet this is
    the worker's local cache; here registration pins the bytes so a
    holder can always serve what the directory says it holds (eviction
    races are the directory's problem in real life, modeled by
    ``invalidate``)."""

    __slots__ = ("wid", "fault", "chunks", "latency", "served", "_lock")

    def __init__(self, wid: int, rng: np.random.Generator):
        self.wid = wid
        self.fault = FaultPlan.healthy()
        self.chunks: dict[str, bytes] = {}
        # worker-to-worker transfer inside one AZ: slightly cheaper
        # serve (no flash tier) but the same network distribution as an
        # L2 stripe GET
        self.latency = LatencyModel(rng, serve_median_s=30e-6)
        self.served = 0
        self._lock = threading.Lock()   # rng is not thread-safe

    def edge_sample(self) -> float:
        """Simulated latency of one tree edge / direct transfer."""
        with self._lock:
            return self.latency.sample()


class _PeerFlight:
    """One in-flight provisioning of a chunk name: a leader pulling the
    bytes from the lower tiers plus the joiners queued behind it as
    positions of a fanout-ary tree. All fields are guarded by the mesh
    lock; ``cond`` shares that lock."""

    __slots__ = ("cond", "leader", "joiners", "ciphertext", "dead",
                 "promoted")

    def __init__(self, lock: threading.Lock, leader: int):
        self.cond = threading.Condition(lock)
        self.leader = leader
        self.joiners: list[int] = []    # join order = tree positions 1..n
        self.ciphertext: bytes | None = None
        self.dead = False               # abandoned with nobody to promote
        self.promoted: int | None = None


class PeerMesh:
    """The shared fabric of an N-worker provisioning mesh. Build ONE
    per fleet; hand each worker's ``ImageService`` a ``client(i)``.

    ``transfer_hook(name, src_wid, dst_wid)`` — optional callback fired
    after every completed peer transfer (benchmarks use it to crash a
    worker mid-storm, reusing the ``FaultPlan`` machinery)."""

    def __init__(self, num_workers: int, *,
                 fanout: int = DEFAULT_PEER_FANOUT,
                 deadline_s: float = DEFAULT_PEER_DEADLINE_S,
                 registration: str = "all",
                 seed: int = 0, transfer_hook=None):
        if registration not in REGISTRATION_POLICIES:
            raise ValueError(f"registration must be one of "
                             f"{REGISTRATION_POLICIES}, got {registration!r}")
        self.fanout = max(1, int(fanout))
        self.deadline_s = float(deadline_s)
        self.registration = registration
        self.transfer_hook = transfer_hook
        self.workers = [_Worker(i, np.random.default_rng(seed * 7919 + i))
                        for i in range(num_workers)]
        self.directory: dict[str, list[int]] = {}
        self.flights: dict[str, _PeerFlight] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ control
    def client(self, worker_id: int) -> "PeerClient":
        return PeerClient(self, worker_id)

    def set_fault(self, worker_id: int, plan: FaultPlan):
        """Switch one worker's fault plan mid-flight (the storm
        benchmark's mid-transfer crash)."""
        self.workers[worker_id].fault = plan

    def holders(self, name: str) -> list[int]:
        with self._lock:
            return list(self.directory.get(name, ()))

    # ----------------------------------------------------------- plumbing
    def _healthy(self, wid: int) -> bool:
        return self.workers[wid].fault.kind == FaultPlan.HEALTHY

    def _register(self, name: str, ct: bytes, wid: int,
                  advertise: bool = True):
        """Store worker `wid`'s serving copy of `name`; with
        ``advertise`` also list it in the directory for direct lookups.
        A flight resolver always stores the copy (its tree joiners
        transfer from it) even when the registration policy keeps it out
        of the directory."""
        w = self.workers[wid]
        with self._lock:
            w.chunks[name] = ct
            if advertise:
                ids = self.directory.setdefault(name, [])
                if wid not in ids:
                    ids.append(wid)
        if advertise:
            COUNTERS.inc("peer.registered_chunks")

    def _transfer(self, name: str, src_wid: int, dst: _Worker,
                  hops: int = 1):
        """Pull `name` from worker `src_wid` over `hops` tree edges.
        Returns (sim latency, ciphertext | None): a faulted or
        since-evicted source fails the transfer (the caller falls
        through), never corrupts."""
        src = self.workers[src_wid]
        if src.fault.kind != FaultPlan.HEALTHY:
            COUNTERS.inc("peer.dead_peer_fallthroughs")
            return (src.edge_sample() if src.fault.kind == FaultPlan.CRASHED
                    else self.deadline_s, None)
        with self._lock:
            ct = src.chunks.get(name)
        if ct is None:
            return (src.edge_sample(), None)
        lat = sum(dst.edge_sample() for _ in range(max(1, hops)))
        with src._lock:
            src.served += 1
        COUNTERS.inc("peer.transfers")
        if self.transfer_hook is not None:
            self.transfer_hook(name, src_wid, dst.wid)
        return (lat, ct)

    def _tree_path(self, flight: _PeerFlight, wid: int) -> list:
        """Ancestor worker ids of joiner `wid` in the flight's
        fanout-ary tree, nearest parent FIRST and the leader LAST.
        Position 0 is the leader; joiner i sits at position i+1 with
        parent (pos-1)//fanout. Caller holds the mesh lock."""
        pos = flight.joiners.index(wid) + 1
        ancestors = []
        p = pos
        while p > 0:
            p = (p - 1) // self.fanout
            ancestors.append(flight.leader if p == 0
                             else flight.joiners[p - 1])
        return ancestors


class PeerClient:
    """One worker's tier-shaped view of the mesh. Interface mirrors the
    L2 (``get_chunk`` / ``put_chunk`` / ``invalidate``) plus the batched
    ``probe_chunks`` the reader's leader stage uses."""

    def __init__(self, mesh: PeerMesh, worker_id: int):
        self.mesh = mesh
        self.wid = int(worker_id)
        self._pool = LazyPool()         # deadline-bounded join waits

    @property
    def worker(self) -> _Worker:
        return self.mesh.workers[self.wid]

    # ------------------------------------------------------------- fetch
    def _direct_fetch(self, name: str):
        """Transfer from any healthy registered holder (one RTT).
        Returns (lat, ct | None); tries up to ``fanout`` holders before
        giving up (dead holders are skipped, not fatal)."""
        me = self.worker
        mesh = self.mesh
        all_holders = [w for w in mesh.holders(name) if w != self.wid]
        # skip known-faulted holders up front (a real client drops dead
        # peers from its view); _transfer still re-checks at serve time,
        # which catches the check-to-serve race
        holders = [w for w in all_holders if mesh._healthy(w)]
        if not holders:
            if all_holders:
                COUNTERS.inc("peer.dead_peer_fallthroughs")
            return (0.0, None)
        with me._lock:
            start = int(me.latency.rng.integers(0, len(holders)))
        lat = 0.0
        for i in range(min(len(holders), mesh.fanout)):
            src = holders[(start + i) % len(holders)]
            tlat, ct = mesh._transfer(name, src, me)
            lat += tlat
            if ct is not None:
                COUNTERS.inc("peer.direct_hits")
                self._after_hit(name, ct)
                return (lat, ct)
        return (lat, None)

    def _after_hit(self, name: str, ct: bytes):
        """Post-transfer bookkeeping: the receiving worker becomes a
        holder itself under the ``"all"`` registration policy (subtree
        re-serving — what makes the tree compound)."""
        if self.mesh.registration == "all":
            self.mesh._register(name, ct, self.wid)

    def _join_wait(self, name: str, flight: _PeerFlight):
        """Wait (deadline-bounded) on a provisioning flight this worker
        joined. Returns (sim latency, ct | None, orphaned): a None with
        ``orphaned=True`` means a faulted tree ancestor (or a parent
        that died between check and serve) cut this worker off from a
        RESOLVED flight and no healthy direct holder covered — the
        caller should re-dedup through the mesh (``_acquire`` loops),
        because the other cut-off waiters are in the same boat and each
        falling through to origin independently re-creates exactly the
        stampede this tier removes. ``orphaned=False`` Nones (promoted
        to leader, dead flight, deadline) mean fall through now."""
        mesh = self.mesh
        deadline = mesh.deadline_s
        with mesh._lock:
            remaining = deadline
            while (flight.ciphertext is None and not flight.dead
                   and flight.promoted != self.wid and remaining > 0):
                t0 = time.monotonic()
                flight.cond.wait(timeout=remaining)
                remaining -= time.monotonic() - t0
            if flight.promoted == self.wid:
                COUNTERS.inc("peer.promotions")
                return (0.0, None, False)   # I lead now: go fetch + publish
            if flight.ciphertext is None:
                if not flight.dead:
                    COUNTERS.inc("peer.deadline_fallthroughs")
                # drop out of the tree so later joiners don't inherit a
                # parent that never received the bytes
                if self.wid in flight.joiners:
                    flight.joiners.remove(self.wid)
                return (deadline, None, False)
            ancestors = mesh._tree_path(flight, self.wid)
            ct = flight.ciphertext
        # fault check OUTSIDE the lock: serve from the nearest HEALTHY
        # ancestor — a joiner whose parent died reconnects to its
        # grandparent (FaaSNet's tree repair) instead of orphaning the
        # whole subtree; only a fully-faulted chain is orphaned (healthy
        # direct holder, else the caller's _acquire loop re-dedups)
        parent = next((a for a in ancestors if mesh._healthy(a)), None)
        if parent is None:
            COUNTERS.inc("peer.dead_peer_fallthroughs")
            lat, got = self._direct_fetch(name)
            return (lat, got, got is None)
        if parent != ancestors[0]:
            COUNTERS.inc("peer.tree_repairs")
        lat, got = mesh._transfer(name, parent, self.worker,
                                  hops=len(ancestors))
        if got is None:                 # parent died between check and serve
            dlat, got = self._direct_fetch(name)
            return (lat + dlat, got, got is None)
        COUNTERS.inc("peer.tree_hits")
        self._after_hit(name, got)
        return (lat, got, False)

    _MAX_REJOINS = 3

    def _acquire(self, name: str):
        """The tier's dedup loop: direct holder fetch, else join or lead
        the chunk's provisioning flight; an ORPHANED join (resolver
        crashed under us, no healthy holder yet) re-enters the loop so
        the cut-off waiters elect ONE new leader among themselves
        instead of all stampeding origin. Returns (sim lat, ct | None);
        a None means this worker now LEADS (or the mesh gave up) and the
        caller must fetch from the lower tiers, then ``put_chunk`` /
        ``abandon``."""
        mesh = self.mesh
        lat = 0.0
        for _ in range(self._MAX_REJOINS + 1):
            dlat, ct = self._direct_fetch(name)
            lat += dlat
            if ct is not None:
                return (lat, ct)
            with mesh._lock:
                flight = mesh.flights.get(name)
                if flight is None:
                    mesh.flights[name] = _PeerFlight(mesh._lock, self.wid)
                    return (lat, None)  # we lead: fall through and publish
                flight.joiners.append(self.wid)
            COUNTERS.inc("peer.joins")
            jlat, ct, orphaned = self._join_wait(name, flight)
            lat += jlat
            if ct is not None or not orphaned:
                return (lat, ct)
        return (lat, None)              # repeated crashes: give up, lead-less
                                        # fall-through (abandon() is a no-op)

    def get_chunk(self, name: str, chunk_len: int):
        """Serial-path probe: (sim latency, ct | None). A None return
        with this worker holding the flight lease means the caller MUST
        eventually ``put_chunk`` (success) or ``abandon`` (failure)."""
        lat, ct = self._acquire(name)
        COUNTERS.inc("peer.hits" if ct is not None else "peer.misses")
        return (lat, ct)

    def probe_chunks(self, names: list, chunk_len: int, on_ready):
        """Batched probe for the reader's leader stage. Direct holder
        hits are served inline (``on_ready(name, lat, ct)``). Names with
        an in-flight provisioning are JOINED: a pool thread waits out
        each flight and calls ``on_ready`` on success; the returned
        futures resolve to ``(lat, ct | None)`` either way, so the
        caller can fall through for the Nones AFTER its own origin
        stage (never blocking its led names behind a peer wait — two
        workers leading each other's chunks must both make progress).
        Returns (lead_names, {joined name: Future})."""
        mesh = self.mesh
        leads, joined = [], {}
        for name in names:
            lat, ct = self._direct_fetch(name)
            if ct is not None:
                COUNTERS.inc("peer.hits")
                on_ready(name, lat, ct)
                continue
            with mesh._lock:
                flight = mesh.flights.get(name)
                if flight is None:
                    mesh.flights[name] = _PeerFlight(mesh._lock, self.wid)
                    COUNTERS.inc("peer.misses")
                    leads.append(name)
                    continue
                flight.joiners.append(self.wid)
            COUNTERS.inc("peer.joins")
            joined[name] = (flight, lat)
        if not joined:
            return leads, {}
        # narrow pool: join waits are almost all idle Condition waits
        # and the post-resolve transfer is cheap, so a big fleet in one
        # process stays at a few threads per worker instead of one per
        # joined chunk
        pool = self._pool.get(min(4, len(joined)))

        def wait_out(name, flight, base_lat):
            jlat, ct, orphaned = self._join_wait(name, flight)
            lat = base_lat + jlat
            if ct is None and orphaned:
                # resolver crashed under us: re-dedup through the mesh
                # (one cut-off waiter leads a fresh flight, the rest
                # join it) instead of every waiter stampeding origin
                alat, ct = self._acquire(name)
                lat += alat
            if ct is not None:
                COUNTERS.inc("peer.hits")
                on_ready(name, lat, ct)
            else:
                COUNTERS.inc("peer.misses")
            return (lat, ct)

        futs: dict[str, Future] = {
            name: pool.submit(wait_out, name, flight, lat)
            for name, (flight, lat) in joined.items()}
        return leads, futs

    # ------------------------------------------------------------ publish
    def put_chunk(self, name: str, ct: bytes, source: str = "origin"):
        """Publish a chunk this worker just acquired from a lower tier:
        register in the directory (per the registration policy) and
        resolve any provisioning flight waiting on it. ``source`` names
        the tier the bytes came from (``"origin"`` | ``"l2"`` |
        ``"publish"``);
        ``"origin"`` always registers, other tiers only under policy
        ``"all"``. Returns 0.0 (registration is directory metadata, not
        a data-path transfer)."""
        mesh = self.mesh
        advertise = source == "origin" or mesh.registration == "all"
        mesh._register(name, ct, self.wid, advertise=advertise)
        with mesh._lock:
            flight = mesh.flights.pop(name, None)
            if flight is not None:
                flight.ciphertext = ct
                # the resolver serves the tree: joiners compute their
                # path against the CURRENT leader, so make that us
                flight.leader = self.wid
                flight.promoted = None
                flight.cond.notify_all()
        return 0.0

    def abandon(self, name: str):
        """Give up a flight lease this worker holds (its lower-tier
        fetch failed). The first joiner is promoted to leader — it falls
        through to origin and publishes for the rest; with no joiners
        the flight dies quietly. A flight led by ANOTHER worker is left
        alone."""
        mesh = self.mesh
        with mesh._lock:
            flight = mesh.flights.get(name)
            if flight is None or flight.leader != self.wid:
                return
            if flight.joiners:
                flight.leader = flight.promoted = flight.joiners.pop(0)
                COUNTERS.inc("peer.abandoned_leases")
            else:
                mesh.flights.pop(name, None)
                flight.dead = True
            flight.cond.notify_all()

    def invalidate(self, name: str):
        """Drop `name` mesh-wide: every holder's serving copy and the
        directory entry (the reader calls this when a chunk fails its
        integrity check, so a retry refetches from origin instead of
        replaying tampered bytes peer-to-peer)."""
        mesh = self.mesh
        with mesh._lock:
            mesh.directory.pop(name, None)
            for w in mesh.workers:      # unadvertised serving copies too
                w.chunks.pop(name, None)
