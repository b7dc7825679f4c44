"""The serial image-create oracle and the deprecated single-image reader
shim (the port of ``repro.core.loader``).

``create_image``: tree -> deterministic layout -> chunks -> zero elision
-> convergent encryption (salted by epoch and root) -> PUT-if-absent
into the root -> sealed manifest, one chunk at a time on the caller
thread. It is the serial oracle of the write path: the batched
``core.publish.PublishPipeline`` gives byte-identical manifests and
chunks, as does the JAX package's ``create_image``.

``ImageReader`` is a thin shim over ``ImageService``/``ImageHandle``: a
private single-image service (no tiers beyond the objects passed in, no
admission control) whose legacy ``batched=/streamed=/parallelism=``
keywords map onto a ``ReadPolicy``. New code constructs an
``ImageService`` and calls ``open``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.blockdev import DEFAULT_PARALLELISM
from repro_torch.core.crypto import convergent
from repro_torch.core.layout import (
    CHUNK_SIZE,
    ImageWriter,
    build_layout,
    canonical_paths,
)
from repro_torch.core.manifest import ZERO_CHUNK, ChunkRef, Manifest, seal
from repro_torch.core.publish import CreateStats, image_id_for
from repro_torch.core.service import ReadPolicy, single_image_service
from repro_torch.core.telemetry import COUNTERS

__all__ = ["CreateStats", "image_id_for", "create_image", "ImageReader",
           "sharding_slices"]


def create_image(tree, *, tenant: str, tenant_key: bytes, store, root: str,
                 salt_epoch: int = 0, image_id: str | None = None,
                 chunk_size: int = CHUNK_SIZE) -> tuple[bytes, CreateStats]:
    """Flatten, chunk, encrypt, upload — one chunk at a time on the
    caller thread, with the host crypto (module doc). Returns (sealed
    manifest blob, stats)."""
    lay = build_layout(tree, chunk_size)
    writer = ImageWriter(lay)
    for name, leaf in canonical_paths(tree):
        writer.put(name, leaf)

    salt = convergent.make_salt(salt_epoch, root)
    image_id = image_id or image_id_for(tree)
    refs, zero, unique, dedup, uploaded = [], 0, 0, 0, 0
    for idx, chunk in writer.chunks():
        if not np.any(np.frombuffer(chunk, np.uint8)):
            refs.append(ChunkRef(idx, ZERO_CHUNK))
            zero += 1
            continue
        enc = convergent.encrypt_chunk(chunk, salt)
        if store.put_if_absent(root, enc.name, enc.ciphertext):
            unique += 1
            uploaded += len(enc.ciphertext)
        else:
            dedup += 1
        refs.append(ChunkRef(idx, enc.name, enc.key, enc.sha256))

    m = Manifest(image_id=image_id, tenant=tenant, root_id=root, salt=salt,
                 chunk_size=chunk_size, image_size=lay.image_size,
                 layout_table=lay.to_table(), chunks=refs)
    blob = seal(m, tenant_key)
    store.put_manifest(root, image_id, blob)
    stats = CreateStats(image_id, len(refs), zero, unique, dedup,
                        lay.image_size, uploaded)
    COUNTERS.inc("loader.images_created")
    return blob, stats


class ImageReader:
    """DEPRECATED single-image shim over ``ImageService``/``ImageHandle``
    (module doc). `root` is the root the manifest was fetched from
    (after a GC migration it differs from the manifest's ``root_id``);
    `peer` is this worker's ``PeerClient``; `decoder` is a
    ``BatchDecoder`` for the session (``"serial"`` is the per-chunk
    oracle); `device` is the device of the service's decode backend.
    An explicit `policy` wins over the legacy keywords."""

    def __init__(self, manifest_blob: bytes, tenant_key: bytes, store,
                 l1=None, l2=None, peer=None, concurrency=None,
                 root: str | None = None, origin_delay_s: float = 0.0,
                 decoder=None, device="cuda"):
        self._service = single_image_service(
            store, l1=l1, l2=l2, peer=peer, fetch_limiter=concurrency,
            origin_delay_s=origin_delay_s, device=device)
        self._handle = self._service.open(manifest_blob, tenant_key,
                                          root=root, decoder=decoder)
        self.manifest = self._handle.manifest
        self.layout = self._handle.layout
        self.reader = self._handle.reader

    def tensor(self, name: str) -> np.ndarray:
        """Serial restore of one tensor (the reference read path)."""
        return self._handle.tensor(name)

    def tensor_names(self) -> list:
        return self._handle.tensor_names()

    @staticmethod
    def _policy(policy, batched, streamed, parallelism) -> ReadPolicy:
        if policy is not None:
            return policy
        return ReadPolicy.from_legacy(batched=batched, streamed=streamed,
                                      parallelism=parallelism)

    def restore_tree(self, names=None, *, batched: bool = True,
                     parallelism: int = DEFAULT_PARALLELISM,
                     streamed: bool = True,
                     policy: ReadPolicy | None = None) -> dict:
        """Flat {path: array} for all (or selected) tensors: streamed by
        default, ``streamed=False`` the staged oracle, ``batched=False``
        the serial one."""
        return self._handle.restore_tree(
            names, self._policy(policy, batched, streamed, parallelism))

    def shard_chunks(self, shard_slices: dict) -> list:
        """Chunk indices needed for {tensor_name: [(start, stop) per dim]}."""
        return self._handle.shard_chunks(shard_slices)

    def restore_shards(self, shard_slices: dict, *,
                       parallelism: int = DEFAULT_PARALLELISM,
                       streamed: bool = True,
                       policy: ReadPolicy | None = None) -> dict:
        """Batched restore of {name: dim_slices | None (full tensor)}."""
        return self._handle.restore_shards(
            shard_slices, self._policy(policy, True, streamed, parallelism))

    def tensor_shard(self, name: str, dim_slices: list,
                     parallelism: int = DEFAULT_PARALLELISM,
                     streamed: bool = True,
                     policy: ReadPolicy | None = None) -> np.ndarray:
        """Fetch only the bytes of one rectangular shard (batched)."""
        return self._handle.tensor_shard(
            name, dim_slices, self._policy(policy, True, streamed,
                                           parallelism))

    def prefetch(self, chunk_indices: list,
                 parallelism: int = DEFAULT_PARALLELISM,
                 streamed: bool = False,
                 policy: ReadPolicy | None = None):
        """Warm the tiers for `chunk_indices` without decoding, staged by
        default, or through the streaming producer (``streamed=True``)."""
        self._handle.prefetch(
            chunk_indices, self._policy(policy, True, streamed, parallelism))


def sharding_slices(shape: tuple, spec_sizes: list, coords: list) -> list:
    """(start, stop) per dim for a device at `coords` in a sharding grid
    of `spec_sizes` shards per dim."""
    out = []
    for dim, (n, c) in zip(shape, zip(spec_sizes, coords)):
        step = dim // n
        out.append((c * step, (c + 1) * step if c < n - 1 else dim))
    return out
