"""Batched publish pipeline — the write path (the port of
``repro.core.publish``; the ``NameIndex`` dedup sidecar and refcounts
are later slices).

The stages, byte-identical to the serial ``create_image`` oracle of the
JAX package (``repro.core.loader``) for the same tree, root and salt
epoch:

* chunk — ``layout.StreamingImageWriter`` yields chunk-aligned windows
  one tensor at a time, gathered into stage batches;
* zero-elide — all-zero chunks become ``ZERO_CHUNK`` refs (§3.2);
* key derivation — one batched SHA pass per stage batch
  (``BatchDecoder.derive_keys_batch``, the backend's ``sha_many``);
* encrypt — ``BatchDecoder.encrypt_batch_timed``: the AES-CTR
  keystreams and the naming SHA pass through the backend's hooks;
* upload — bounded-parallel ``put_if_absent`` (under the optional
  ``RetryPolicy``); encryption of stage batch N+1 overlaps the uploads
  of batch N; each new chunk warms the optional L1 and peer tier;
* seal — the manifest, authenticated, key table encrypted.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.concurrency import BlockingLimiter, LazyPool
from repro_torch.core.crypto import convergent
from repro_torch.core.decode import BatchDecoder
from repro_torch.core.layout import (
    CHUNK_SIZE,
    StreamingImageWriter,
    build_layout,
    canonical_paths,
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


def image_id_for(tree) -> str:
    """SHA-256 over the canonical (name, bytes) sequence, first 32 hex
    digits — the JAX package's image id for the same tree."""
    h = hashlib.sha256()
    for name, leaf in canonical_paths(tree):
        h.update(name.encode())
        h.update(np.ascontiguousarray(np.asarray(leaf)).view(np.uint8)
                 .tobytes())
    return h.hexdigest()[:32]


class PublishPipeline:
    """The batched write path over one ``ChunkStore`` (module doc).
    ``ImageService`` owns one; all methods are thread-safe."""

    def __init__(self, store, *, backend: str = "torch-fused",
                 tile_bytes: int | str | None = None, l1=None, peer=None,
                 retry=None, counters=None, device="cuda"):
        self.store = store
        self.decoder = BatchDecoder(backend, max_batch_bytes=tile_bytes,
                                    device=device)
        self.upload_parallelism = DEFAULT_UPLOAD_PARALLELISM
        self.l1 = l1
        self.peer = peer
        self.retry = retry
        self.counters = counters if counters is not None else COUNTERS
        self._pool = LazyPool()
        self._limiter = BlockingLimiter(self.upload_parallelism)
        self.stage_bytes = max(MIN_STAGE_BYTES, self.decoder.max_batch_bytes)
        self.last_timing: dict = {}

    def publish(self, tree, *, tenant: str, tenant_key: bytes, root: str,
                salt_epoch: int = 0, chunk_size: int = CHUNK_SIZE) -> tuple:
        """Flatten, chunk, encrypt, upload, seal. Returns (sealed
        manifest blob, CreateStats). ``last_timing`` holds the seconds
        spent in the crypto hooks and in the whole call."""
        t0 = time.perf_counter()
        lay = build_layout(tree, chunk_size)
        items = canonical_paths(tree)
        salt = convergent.make_salt(salt_epoch, root)
        image_id = image_id_for(tree)
        t_id = time.perf_counter() - t0
        refs: dict[int, ChunkRef] = {}
        futures: list = []
        zero = 0
        crypto_s = 0.0
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
                crypto_s += self._publish_batch(batch, salt, root, refs,
                                                futures)
                batch, batch_bytes = [], 0
        if batch:
            crypto_s += self._publish_batch(batch, salt, root, refs, futures)
        unique = uploaded = dedup = 0
        for f in futures:
            nnew, ndup, nbytes = f.result()
            unique += nnew
            dedup += ndup
            uploaded += nbytes
        chunks = [refs[i] for i in sorted(refs)]
        m = Manifest(image_id=image_id, tenant=tenant, root_id=root,
                     salt=salt, chunk_size=chunk_size,
                     image_size=lay.image_size,
                     layout_table=lay.to_table(), chunks=chunks)
        blob = seal(m, tenant_key)
        self.store.put_manifest(root, image_id, blob)
        stats = CreateStats(image_id, len(chunks), zero, unique, dedup,
                            lay.image_size, uploaded)
        wall = time.perf_counter() - t0
        self.last_timing = {"wall_s": wall, "crypto_s": crypto_s,
                            "image_id_s": t_id}
        self.counters.inc("publish.images_published")
        self.counters.add("publish.wall_s", wall)
        return blob, stats

    def _publish_batch(self, batch: list, salt: bytes, root: str,
                       refs: dict, futures: list) -> float:
        """One stage batch: batched key derivation and encryption, then
        upload submits (drained by ``publish``). Returns the seconds
        spent in the crypto hooks."""
        t0 = time.perf_counter()
        pts = [c for _, c in batch]
        keys = self.decoder.derive_keys_batch(pts, salt)
        encs, _ = self.decoder.encrypt_batch_timed(pts, salt, keys=keys)
        crypto_s = time.perf_counter() - t0
        for (idx, _), enc in zip(batch, encs):
            refs[idx] = ChunkRef(idx, enc.name, enc.key, enc.sha256)
        # upload in groups (about two per worker): per-chunk futures would
        # dominate small-chunk images
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
        return crypto_s

    def _upload_group(self, root: str, items: list) -> tuple:
        """(new_chunks, dedup_chunks, uploaded_bytes) of one group of
        PUT-if-absent uploads; the limiter slot is released here."""
        new = dup = nbytes = 0
        try:
            for name, ct in items:
                if self._put(root, name, ct):
                    new += 1
                    nbytes += len(ct)
                    self.counters.inc("publish.chunks_uploaded")
                    if self.l1 is not None:
                        self.l1.put(name, ct)        # warm the local tier
                    if self.peer is not None:
                        self.peer.put_chunk(name, ct, source="publish")
                else:
                    dup += 1
            return new, dup, nbytes
        finally:
            self._limiter.release()

    def _put(self, root: str, name: str, ct: bytes) -> bool:
        """One PUT-if-absent, retried under the policy when one is set."""
        if self.retry is None:
            return self.store.put_if_absent(root, name, ct)
        return self.retry.call(
            lambda: self.store.put_if_absent(root, name, ct),
            counters=self.counters)

    def close(self):
        """Drain the upload pool (idempotent)."""
        self._pool.shutdown()
        self.decoder.close()
