"""Generational root-based garbage collection (paper §3.4), refcounted
and safe to run CONCURRENTLY with live streamed restores (the port of
``repro.core.gc``: the same names, defaults and ``gc.*`` counters).

Roots cycle active -> retired -> expired -> deleted. Retiring migrates
still-referenced manifests (and every chunk they reference — readable from
the manifest's *public* body, no keys needed) into the new active root.
Expired roots serve reads but alarm and freeze deletions; deletion only
proceeds for quiet expired roots. Multiple simultaneously-active roots are
supported (blast-radius / staged-rollout, §3.4 last para).

Three pieces make collection concurrent with serving:

* ``RefcountIndex`` — per-root chunk refcounts, maintained at publish
  time (``PublishPipeline`` bumps it under the publish lock) and at
  retire time (``retire_image`` decrements and reports newly
  zero-referenced chunks). ``sweep`` deletes zero-ref chunks without a
  stop-the-world manifest scan — but always re-validates against the
  manifests actually present in the root, so images published outside
  the index (e.g. the serial ``create_image`` oracle) are never swept.
* ``RootPinRegistry`` — the epoch/pin protocol. In-flight readers pin
  their root for the duration of a read (``TieredReader`` wraps every
  public entry point); ``delete_expired`` and ``sweep`` refuse while the
  root is pinned. A generation roll mid-restore therefore cannot pull
  chunks out from under the reader: the restore stays byte-identical to
  a serial oracle run (tested in ``tests/test_torch_gc.py``).
* batched ``migrate`` — when a ``PublishPipeline`` is attached, chunk
  migration runs through ``copy_chunks`` (one batched presence probe on
  the destination root + bounded-parallel single-flighted copies)
  instead of a serial has/get/put per chunk.
"""
from __future__ import annotations

import itertools
import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field

from repro_torch.core import manifest as manifest_mod
from repro_torch.core.telemetry import COUNTERS


class RootPinRegistry:
    """Thread-safe per-root pin counts — the reader side of the GC's
    epoch/pin protocol. A pinned root may not be deleted or swept."""

    def __init__(self):
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    @contextmanager
    def pin(self, root: str):
        with self._lock:
            self._counts[root] = self._counts.get(root, 0) + 1
        try:
            yield
        finally:
            with self._lock:
                n = self._counts.get(root, 1) - 1
                if n <= 0:
                    self._counts.pop(root, None)
                else:
                    self._counts[root] = n

    def pinned(self, root: str) -> bool:
        with self._lock:
            return self._counts.get(root, 0) > 0

    def count(self, root: str) -> int:
        with self._lock:
            return self._counts.get(root, 0)


class RefcountIndex:
    """Per-root chunk refcounts: {root: {image_id: names}} plus a name →
    reference-count Counter per root. Maintained at publish time and at
    retire time; ``migrate`` re-registers migrated images on the new
    root. All methods are thread-safe (publishers are concurrent)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._images: dict[str, dict] = {}     # root -> {image_id: frozenset}
        self._counts: dict[str, Counter] = {}  # root -> Counter(name -> refs)

    def add_image(self, root: str, image_id: str, names) -> None:
        s = frozenset(names)
        with self._lock:
            imgs = self._images.setdefault(root, {})
            if image_id in imgs:          # idempotent republish
                return
            imgs[image_id] = s
            cnt = self._counts.setdefault(root, Counter())
            for n in s:
                cnt[n] += 1

    def remove_image(self, root: str, image_id: str) -> set:
        """Drop an image's references; returns the chunk names that just
        went to ZERO references (sweep candidates)."""
        with self._lock:
            s = self._images.get(root, {}).pop(image_id, None)
            if s is None:
                return set()
            cnt = self._counts[root]
            dead = set()
            for n in s:
                cnt[n] -= 1
                if cnt[n] <= 0:
                    del cnt[n]
                    dead.add(n)
            return dead

    def refcount(self, root: str, name: str) -> int:
        with self._lock:
            return self._counts.get(root, Counter()).get(name, 0)

    def live_chunks(self, root: str) -> set:
        with self._lock:
            return set(self._counts.get(root, ()))

    def live_images(self, root: str) -> set:
        with self._lock:
            return set(self._images.get(root, ()))

    def image_chunks(self, root: str, image_id: str) -> frozenset:
        with self._lock:
            return self._images.get(root, {}).get(image_id, frozenset())


@dataclass
class GCStats:
    migrated_manifests: int = 0
    migrated_chunks: int = 0
    swept_chunks: int = 0
    deleted_roots: list = field(default_factory=list)
    alarms: list = field(default_factory=list)


class GenerationalGC:
    def __init__(self, store, first_root: str = "R1", *, pipeline=None,
                 refcounts: RefcountIndex | None = None,
                 pins: RootPinRegistry | None = None):
        self.store = store
        self._counter = itertools.count(2)
        self.active_roots = [first_root]
        self.retired: list[str] = []
        self.expired: list[str] = []
        self.stats = GCStats()
        self.pipeline = pipeline          # PublishPipeline for batched copies
        self.refcounts = refcounts if refcounts is not None else RefcountIndex()
        self.pins = pins if pins is not None else RootPinRegistry()
        self.epoch = 0                    # bumped per generation roll
        store.create_root(first_root)
        store.on_expired_read(self._alarm)

    # ------------------------------------------------------------- alarms
    def _alarm(self, root: str):
        self.stats.alarms.append(root)
        COUNTERS.inc("gc.expired_read_alarms")

    # -------------------------------------------------------------- cycle
    @property
    def active(self) -> str:
        return self.active_roots[-1]

    def new_root(self) -> str:
        """Create a new active root; the OLDEST active root is retired.

        With staged-rollout roots (``add_active_root``) the list holds
        several generations, oldest first — rolling the generation must
        retire the oldest one, not the most recently staged root (which
        would silently yank a rollout mid-flight while the old
        generation lived on). Rolling bumps the GC epoch (new publishes
        salt under the new generation); readers mid-restore on the old
        root are unaffected — retired roots serve reads, and their pins
        block deletion until they drain."""
        nxt = f"R{next(self._counter)}"
        self.store.create_root(nxt)
        prev = self.active_roots.pop(0) if self.active_roots else None
        self.active_roots.append(nxt)
        self.epoch += 1
        if prev is not None:
            self.store._set_state(prev, "retired")
            self.retired.append(prev)
        return nxt

    def migrate(self, from_root: str, live_images: set | None = None):
        """Copy still-referenced manifests + their chunks to the active root.

        Reads only the PUBLIC manifest body (chunk names) — the GC never
        holds tenant keys. Manifests keep their original salt/keys; their
        chunks become readable in the new root under the same names.

        `live_images` defaults to the refcount index's live set for the
        root. With a ``PublishPipeline`` attached the chunk copies are
        batched (one destination presence probe, bounded-parallel
        single-flighted copies); otherwise the serial has/get/put loop.
        Migrated images are re-registered in the refcount index under
        the destination root.
        """
        to_root = self.active
        if live_images is None:
            live_images = self.refcounts.live_images(from_root)
        todo: list = []                       # (image_id, blob, names)
        want: dict = {}                       # ordered de-dup of chunk names
        for image_id in self.store.list_manifests(from_root):
            if image_id not in live_images:
                continue
            blob = self.store.get_manifest(from_root, image_id)
            pub = manifest_mod.read_public(blob)
            names = [name for _idx, name, _sha in pub["chunks"]
                     if name != manifest_mod.ZERO_CHUNK]
            todo.append((image_id, blob, names))
            for n in names:
                want[n] = True
        if self.pipeline is not None:
            self.stats.migrated_chunks += self.pipeline.copy_chunks(
                from_root, to_root, list(want))
        else:
            for name in want:
                if not self.store.has_chunk(to_root, name):
                    data = self.store.get_chunk(from_root, name)
                    self.store.put_if_absent(to_root, name, data)
                    self.stats.migrated_chunks += 1
        for image_id, blob, names in todo:
            self.store.put_manifest(to_root, image_id, blob)
            self.refcounts.add_image(to_root, image_id, names)
            self.stats.migrated_manifests += 1
        COUNTERS.inc("gc.migrations")

    def retire_image(self, root: str, image_id: str) -> set:
        """Drop one image's references (checkpoint retention policy).
        Deletes its manifest and returns the chunk names that became
        zero-referenced — candidates for the next ``sweep``. The chunks
        themselves are NOT deleted here (a concurrent reader may hold
        the manifest already; sweep honors pins)."""
        dead = self.refcounts.remove_image(root, image_id)
        self.store.delete_manifest(root, image_id)
        COUNTERS.inc("gc.images_retired")
        return dead

    def sweep(self, root: str) -> int:
        """Delete zero-referenced chunks in `root`. Deferred (returns 0)
        while the root is pinned by an in-flight reader or deletions are
        frozen by an expired-read alarm.

        The refcount index is the fast path, but safety never depends on
        it: chunks referenced by ANY manifest still present in the root
        are kept, even if that image was published outside the index
        (e.g. by the serial ``create_image`` oracle)."""
        if self.pins.pinned(root):
            COUNTERS.inc("gc.sweeps_deferred_pinned")
            return 0
        if self.store.deletion_frozen:
            COUNTERS.inc("gc.deletions_blocked")
            return 0
        live = self.refcounts.live_chunks(root)
        indexed = self.refcounts.live_images(root)
        for image_id in self.store.list_manifests(root):
            if image_id in indexed:
                continue
            try:
                pub = manifest_mod.read_public(
                    self.store.get_manifest(root, image_id))
            except Exception:
                # the manifest namespace also holds non-image blobs
                # (e.g. checkpoint ``.meta`` sidecars) — they reference
                # no chunks, so they cannot keep anything alive
                COUNTERS.inc("gc.sweep_nonimage_manifests")
                continue
            live.update(name for _i, name, _s in pub["chunks"]
                        if name != manifest_mod.ZERO_CHUNK)
        swept = 0
        for name in self.store.list_chunks(root):
            if name not in live:
                self.store.delete_chunk(root, name)
                swept += 1
        self.stats.swept_chunks += swept
        COUNTERS.add("gc.swept_chunks", swept)
        return swept

    def expire(self, root: str):
        assert root in self.retired, f"{root} is not retired"
        self.retired.remove(root)
        self.store._set_state(root, "expired")
        self.expired.append(root)

    def delete_expired(self, root: str) -> bool:
        """Delete an expired root — refused if any alarm fired (paper: any
        expired-root access stops further deletion) or while an
        in-flight reader still pins the root (epoch/pin protocol: the
        mid-restore reader finishes byte-identical, THEN the root
        goes)."""
        assert root in self.expired
        if self.pins.pinned(root):
            COUNTERS.inc("gc.deletions_blocked_pinned")
            return False
        if self.store.deletion_frozen:
            COUNTERS.inc("gc.deletions_blocked")
            return False
        self.store.delete_root(root)
        self.expired.remove(root)
        self.stats.deleted_roots.append(root)
        return True

    def add_active_root(self) -> str:
        """Additional simultaneously-active root (staged rollout)."""
        nxt = f"R{next(self._counter)}"
        self.store.create_root(nxt)
        self.active_roots.append(nxt)
        return nxt
