"""Batched publish pipeline — the write path (the port of
``repro.core.publish``: the same names, defaults and ``publish.*``
counters).

The stages, byte-identical to the serial ``create_image`` oracle
(``core.loader``, and the JAX package's) for the same tree, root and
salt epoch:

* chunk — ``layout.StreamingImageWriter`` yields chunk-aligned windows
  one tensor at a time, gathered into stage batches;
* zero-elide — all-zero chunks become ``ZERO_CHUNK`` refs (§3.2);
* key derivation — one batched SHA pass per stage batch
  (``BatchDecoder.derive_keys_batch``, the backend's ``sha_many``);
* dedup probe — a ``NameIndex`` (convergent key -> ciphertext name)
  resolves chunks seen before to their names without encrypting them,
  and one batched ``store.has_chunks`` probe per stage batch confirms
  they are present in the root: dedup'd chunks skip encryption
  (``publish.encrypt_skipped_chunks``/``_bytes``, §3.2);
* encrypt — ``BatchDecoder.encrypt_batch_timed`` for the rest: the
  AES-CTR keystreams and the naming SHA pass through the backend's
  hooks;
* upload — bounded-parallel ``put_if_absent`` (under the optional
  ``RetryPolicy``), single-flighted per (root, name) across concurrent
  publishers (``UploadFlights``); encryption of stage batch N+1
  overlaps the uploads of batch N; each new chunk warms the optional
  L1 and peer tier;
* seal — the manifest, authenticated, key table encrypted; the image
  is registered in the GC's ``RefcountIndex`` when one is attached,
  and the name index is saved to its sidecar file when it has one.

``GenerationalGC.migrate`` copies chunks between roots through
``copy_chunks`` (one batched presence probe, bounded-parallel
single-flighted copies).
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from repro_torch.core.concurrency import BlockingLimiter, LazyPool
from repro_torch.core.crypto import convergent
from repro_torch.core.decode import BatchDecoder
from repro_torch.core.layout import (
    CHUNK_SIZE,
    StreamingImageWriter,
    build_layout,
    canonical_paths,
    leaf_bytes,
)
from repro_torch.core.manifest import ZERO_CHUNK, ChunkRef, Manifest, seal
from repro_torch.core.telemetry import COUNTERS

DEFAULT_UPLOAD_PARALLELISM = 8
MIN_STAGE_BYTES = 1 << 20


@dataclass
class CreateStats:
    """Per-image creation statistics (the Fig 5 data)."""

    image_id: str
    total_chunks: int
    zero_chunks: int
    unique_chunks: int          # newly uploaded (not previously in store)
    dedup_chunks: int           # present already (cross/self dedup)
    bytes_total: int
    bytes_uploaded: int

    @property
    def unique_fraction(self) -> float:
        nz = self.total_chunks - self.zero_chunks
        return self.unique_chunks / max(1, nz)


def image_id_for(tree_or_bytes) -> str:
    """SHA-256 over the canonical (name, bytes) sequence of a tree, or
    of raw ``bytes``, first 32 hex digits — the JAX package's image id
    for the same input."""
    if isinstance(tree_or_bytes, bytes):
        return hashlib.sha256(tree_or_bytes).hexdigest()[:32]
    tree = tree_or_bytes
    h = hashlib.sha256()
    for name, leaf in canonical_paths(tree):
        h.update(name.encode())
        h.update(leaf_bytes(leaf).tobytes())
    return h.hexdigest()[:32]


class NameIndex:
    """Convergent key -> ciphertext name, process-wide and salt-safe:
    the key is SHA256(salt ‖ plaintext), so it fixes the plaintext and
    the salt, and the mapping to the ciphertext name is global (roots
    only gate presence, which ``has_chunks`` probes separately).

    With a ``path`` the index persists to a sidecar file (one
    ``<key hex> <name>`` line per entry, the JAX package's format):
    loaded at construction, saved atomically by ``save()``, which
    ``PublishPipeline.publish`` calls after each publish. The sidecar
    is a cache: a corrupt or missing file only costs re-encryption, so
    a load error starts empty (``publish.name_index_load_errors``).
    Past ``cap`` entries the oldest half is dropped."""

    def __init__(self, cap: int = 1 << 20, path=None):
        self.cap = cap
        self.path = Path(path) if path is not None else None
        self._map: dict[bytes, str] = {}
        self._lock = threading.Lock()
        if self.path is not None:
            self._load()

    def _load(self):
        try:
            raw = self.path.read_text()
        except OSError:
            return
        loaded: dict[bytes, str] = {}
        try:
            for line in raw.splitlines():
                k, _, name = line.partition(" ")
                if k and name:
                    loaded[bytes.fromhex(k)] = name
        except ValueError:
            COUNTERS.inc("publish.name_index_load_errors")
            return
        self._map.update(loaded)
        COUNTERS.add("publish.name_index_loaded", len(loaded))

    def save(self):
        """Atomic sidecar write (no-op without a path): concurrent
        savers each write a whole snapshot and ``os.replace`` one."""
        if self.path is None:
            return
        with self._lock:
            items = list(self._map.items())
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(
            self.path.name + ".tmp-%d" % threading.get_ident())
        with open(tmp, "w") as f:
            f.write("".join(f"{k.hex()} {v}\n" for k, v in items))
        os.replace(tmp, self.path)
        COUNTERS.inc("publish.name_index_saves")

    def get_many(self, keys: list) -> list:
        with self._lock:
            return [self._map.get(k) for k in keys]

    def put_many(self, pairs) -> None:
        with self._lock:
            for k, name in pairs:
                self._map[k] = name
            if self.cap and len(self._map) > self.cap:
                # drop the oldest half (insertion order): a miss only
                # costs re-encryption
                drop = len(self._map) - self.cap // 2
                for k in list(self._map)[:drop]:
                    del self._map[k]
                COUNTERS.inc("publish.name_index_trims")

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)


class _Flight:
    __slots__ = ("event", "error")

    def __init__(self):
        self.event = threading.Event()
        self.error: BaseException | None = None


class UploadFlights:
    """Single-flight per (root, name) across concurrent publishers: of N
    racing uploads of one chunk, one PUTs and the rest wait on its
    flight and report dedup. The store's atomic ``put_if_absent``
    stays the correctness backstop; this removes the duplicated upload
    work."""

    def __init__(self):
        self._flights: dict[tuple, _Flight] = {}
        self._lock = threading.Lock()

    def begin(self, root: str, name: str) -> tuple:
        """(leader?, flight)."""
        with self._lock:
            flight = self._flights.get((root, name))
            if flight is None:
                flight = self._flights[(root, name)] = _Flight()
                return True, flight
            return False, flight

    def finish(self, root: str, name: str, flight: _Flight,
               error: BaseException | None = None) -> None:
        flight.error = error
        with self._lock:
            self._flights.pop((root, name), None)
        flight.event.set()


class PublishPipeline:
    """The batched write path over one ``ChunkStore`` (module doc).
    ``ImageService`` owns one, and concurrent ``publish`` calls share
    its name index, upload flights and upload pool; all methods are
    thread-safe."""

    def __init__(self, store, *, backend: str = "torch-fused",
                 tile_bytes: int | str | None = None,
                 upload_parallelism: int = DEFAULT_UPLOAD_PARALLELISM,
                 l1=None, peer=None, refcounts=None,
                 name_index: NameIndex | None = None, name_index_path=None,
                 flights: UploadFlights | None = None, counters=None,
                 retry=None, device="cuda"):
        self.store = store
        self.decoder = BatchDecoder(backend, max_batch_bytes=tile_bytes,
                                    device=device)
        self.upload_parallelism = max(1, int(upload_parallelism))
        self.l1 = l1
        self.peer = peer
        self.refcounts = refcounts
        self.retry = retry
        self.names = name_index if name_index is not None \
            else NameIndex(path=name_index_path)
        self.flights = flights if flights is not None else UploadFlights()
        self.counters = counters if counters is not None else COUNTERS
        self._pool = LazyPool()
        self._limiter = BlockingLimiter(self.upload_parallelism)
        self.stage_bytes = max(MIN_STAGE_BYTES, self.decoder.max_batch_bytes)
        self.last_timing: dict = {}

    def publish(self, tree, *, tenant: str, tenant_key: bytes, root: str,
                salt_epoch: int = 0, image_id: str | None = None,
                chunk_size: int = CHUNK_SIZE) -> tuple:
        """Flatten, chunk, dedup, encrypt, upload, seal. Returns (sealed
        manifest blob, CreateStats). ``last_timing`` holds the seconds
        spent in the crypto hooks, in the dedup probes and in the whole
        call."""
        t0 = time.perf_counter()
        lay = build_layout(tree, chunk_size)
        items = canonical_paths(tree)
        salt = convergent.make_salt(salt_epoch, root)
        image_id = image_id or image_id_for(tree)
        t_id = time.perf_counter() - t0
        refs: dict[int, ChunkRef] = {}
        futures: list = []
        zero = probe_dedup = 0
        timing = {"crypto_s": 0.0, "probe_s": 0.0}
        batch: list = []
        batch_bytes = 0
        for idx, chunk in StreamingImageWriter(lay).chunks(items):
            if chunk.count(0) == len(chunk):
                refs[idx] = ChunkRef(idx, ZERO_CHUNK)
                zero += 1
                continue
            batch.append((idx, chunk))
            batch_bytes += len(chunk)
            if batch_bytes >= self.stage_bytes:
                probe_dedup += self._publish_batch(batch, salt, root, refs,
                                                   futures, timing)
                batch, batch_bytes = [], 0
        if batch:
            probe_dedup += self._publish_batch(batch, salt, root, refs,
                                               futures, timing)
        unique = uploaded = upload_dedup = 0
        for f in futures:
            nnew, ndup, nbytes = f.result()
            unique += nnew
            upload_dedup += ndup
            uploaded += nbytes
        chunks = [refs[i] for i in sorted(refs)]
        m = Manifest(image_id=image_id, tenant=tenant, root_id=root,
                     salt=salt, chunk_size=chunk_size,
                     image_size=lay.image_size,
                     layout_table=lay.to_table(), chunks=chunks)
        blob = seal(m, tenant_key)
        self.store.put_manifest(root, image_id, blob)
        if self.refcounts is not None:
            self.refcounts.add_image(
                root, image_id,
                [c.name for c in chunks if c.name != ZERO_CHUNK])
        stats = CreateStats(image_id, len(chunks), zero, unique,
                            probe_dedup + upload_dedup, lay.image_size,
                            uploaded)
        wall = time.perf_counter() - t0
        self.last_timing = {"wall_s": wall, "image_id_s": t_id, **timing}
        self.counters.inc("publish.images_published")
        self.counters.add("publish.wall_s", wall)
        self.names.save()           # no-op without a sidecar path
        return blob, stats

    def _publish_batch(self, batch: list, salt: bytes, root: str,
                       refs: dict, futures: list, timing: dict) -> int:
        """One stage batch: batched key derivation, then the name-index
        lookup and one ``has_chunks`` probe (dedup'd chunks resolved
        without encryption), batched encryption of the rest and their
        upload submits (drained by ``publish``, so the next batch's
        encryption overlaps these uploads). Returns the probe-dedup
        count; adds the seconds spent in the crypto hooks and in the
        probes to `timing`."""
        t0 = time.perf_counter()
        idxs = [i for i, _ in batch]
        pts = [c for _, c in batch]
        keys = self.decoder.derive_keys_batch(pts, salt)
        t1 = time.perf_counter()
        names = self.names.get_many(keys)
        known = [names[p] for p, n in enumerate(names) if n is not None]
        present = self.store.has_chunks(root, known) if known else set()
        skipped = skipped_bytes = 0
        to_encrypt: list[int] = []
        for p, (idx, name) in enumerate(zip(idxs, names)):
            if name is not None and name in present:
                refs[idx] = ChunkRef(idx, name, keys[p], bytes.fromhex(name))
                skipped += 1
                skipped_bytes += len(pts[p])
            else:
                to_encrypt.append(p)
        t2 = time.perf_counter()
        timing["probe_s"] += t2 - t1
        timing["crypto_s"] += t1 - t0
        if skipped:
            self.counters.add("publish.encrypt_skipped_chunks", skipped)
            self.counters.add("publish.encrypt_skipped_bytes", skipped_bytes)
        if not to_encrypt:
            return skipped
        encs, _ = self.decoder.encrypt_batch_timed(
            [pts[p] for p in to_encrypt], salt,
            keys=[keys[p] for p in to_encrypt])
        timing["crypto_s"] += time.perf_counter() - t2
        self.names.put_many((e.key, e.name) for e in encs)
        for p, enc in zip(to_encrypt, encs):
            refs[idxs[p]] = ChunkRef(idxs[p], enc.name, enc.key, enc.sha256)
        # upload in groups (about two per worker): per-chunk futures would
        # dominate small-chunk images; a duplicate name within the batch
        # is a store dedup or a single-flight follow
        items = [(e.name, e.ciphertext) for e in encs]
        gsz = max(1, -(-len(items) // (2 * self.upload_parallelism)))
        for g in range(0, len(items), gsz):
            self._limiter.acquire()
            try:
                futures.append(self._pool.get(self.upload_parallelism)
                               .submit(self._upload_group, root,
                                       items[g:g + gsz]))
            except BaseException:
                self._limiter.release()
                raise
        self.counters.inc("publish.stage_batches")
        return skipped

    def _upload_group(self, root: str, items: list) -> tuple:
        """(new_chunks, dedup_chunks, uploaded_bytes) of one group of
        single-flighted PUT-if-absent uploads; the limiter slot is
        released here."""
        new = dup = nbytes = 0
        try:
            for name, ct in items:
                if self._upload_one(root, name, ct):
                    new += 1
                    nbytes += len(ct)
                else:
                    dup += 1
            return new, dup, nbytes
        finally:
            self._limiter.release()

    def _upload_one(self, root: str, name: str, ct: bytes) -> bool:
        """One single-flighted ``_put``; True if newly uploaded. A
        follower of a failed leader makes its own attempt."""
        leader, flight = self.flights.begin(root, name)
        if not leader:
            flight.event.wait()
            if flight.error is None:
                self.counters.inc("publish.upload_singleflight_dedup")
                return False
        err = None
        try:
            was_new = self._put(root, name, ct)
        except BaseException as e:
            err = e
            raise
        finally:
            if leader:
                self.flights.finish(root, name, flight, err)
        if was_new:
            self.counters.inc("publish.chunks_uploaded")
            if self.l1 is not None:
                self.l1.put(name, ct)                # warm the local tier
            if self.peer is not None:
                self.peer.put_chunk(name, ct, source="publish")
        return was_new

    def _put(self, root: str, name: str, ct: bytes) -> bool:
        """One PUT-if-absent, retried under the policy when one is set."""
        if self.retry is None:
            return self.store.put_if_absent(root, name, ct)
        return self.retry.call(
            lambda: self.store.put_if_absent(root, name, ct),
            counters=self.counters)

    # ---------------------------------------------------------- migration
    def copy_chunks(self, from_root: str, to_root: str, names,
                    parallelism: int | None = None) -> int:
        """Copy `names` from `from_root` into `to_root` (the GC's batched
        migration): one presence probe on the destination, then
        single-flighted GET+PUT copies, `parallelism` at a time (None:
        the pipeline's ``upload_parallelism``). Returns the number of
        chunks copied."""
        want = [n for n in dict.fromkeys(names) if n != ZERO_CHUNK]
        if not want:
            return 0
        present = self.store.has_chunks(to_root, want)
        missing = [n for n in want if n not in present]
        if not missing:
            return 0

        def copy_one(name: str) -> int:
            leader, flight = self.flights.begin(to_root, name)
            if not leader:
                flight.event.wait()
                if flight.error is None:
                    return 0
            err = None
            try:
                data = self.store.get_chunk(from_root, name)
                return int(self.store.put_if_absent(to_root, name, data))
            except BaseException as e:
                err = e
                raise
            finally:
                if leader:
                    self.flights.finish(to_root, name, flight, err)

        par = parallelism or self.upload_parallelism
        copied = sum(self._pool.get(par).map(copy_one, missing))
        self.counters.add("publish.migrated_chunk_copies", copied)
        return copied

    def close(self):
        """Drain the upload pool (idempotent)."""
        self._pool.shutdown()
        self.decoder.close()
