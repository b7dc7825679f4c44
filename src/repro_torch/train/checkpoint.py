"""Chunk-store-backed checkpointing (the port of
``repro.train.checkpoint``): the paper's system AS the training
framework's checkpoint layer.

Every checkpoint is a flattened image in the content-addressed store:
  * unchanged tensors (frozen layers, embeddings in late training, the
    base model under LoRA-style fine-tuning) dedup to ZERO new chunks —
    incremental checkpointing falls out of content addressing;
  * restore is demand-paged and shard-aware: a recovering worker fetches
    only its shard's byte ranges, through the L1/L2 cache tiers — the
    paper's cold-start path, repurposed as elastic-recovery fast-start;
  * uploads run on a background thread (async checkpointing): the train
    loop snapshots to host memory and continues. Upload failures are
    captured and re-raised on the NEXT ``save()`` / ``wait()`` — an
    async checkpointer that swallows its exceptions silently loses
    checkpoints (``ckpt.upload_failures`` counts them).

With an ``ImageService`` attached (``service=``), uploads publish
through the shared batched write path (``core.publish``): its key
derivation and encryption run the SHA-256 and AES kernels on the card,
dedup'd PUTs, refcount maintenance for the GC, and L1/peer warming.
Restores then open through the same service (shared tiers,
single-flight, the fused verify+decrypt kernel). Without a service, the
serial ``create_image`` / ``ImageReader`` paths are used, the reader on
`device`.

Trees are nested dicts (and lists) of torch tensors or numpy arrays.
The host snapshot (``state_to_tree``) is a flat ``{path: leaf}`` dict of
numpy arrays, except bfloat16 leaves, which stay CPU torch tensors
(numpy has no bfloat16 without ``ml_dtypes``; ``core.layout`` writes
them under the dtype string ``"bfloat16"``, as the JAX package does).
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.layout import (
    BF16,
    bf16_tensor,
    canonical_paths,
    dtype_name,
    leaf_array,
    leaf_dtype,
)
from repro_torch.core.loader import ImageReader, create_image
from repro_torch.core.telemetry import COUNTERS


@dataclass(frozen=True)
class LeafSpec:
    """Shape and numpy dtype of one leaf of a template tree."""
    shape: tuple
    dtype: np.dtype


def _host(leaf):
    """A host copy of one leaf: numpy, or a CPU tensor for bfloat16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        return t if leaf_dtype(t) == BF16 else t.numpy()
    return np.array(leaf, copy=True)


def state_to_tree(state) -> dict:
    """Device tree -> flat {path: leaf} dict (a synchronous host
    snapshot, module doc)."""
    return {p: _host(leaf) for p, leaf in canonical_paths(state)}


def tree_from_flat(template, flat: dict):
    """Rebuild the nested structure of `template` (leaves with
    ``shape`` and a numpy or torch ``dtype``: ``LeafSpec``s, meta
    tensors) from {path: leaf}, casting each leaf to the template's
    dtype and shape: numpy arrays, and CPU torch tensors for bfloat16
    leaves."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, prefix + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + [str(i)])
                              for i, v in enumerate(node))
        arr = flat["/".join(prefix)]
        dtype = dtype_name(node.dtype)
        if dtype == BF16:
            return bf16_tensor(arr).reshape(node.shape)
        return np.asarray(leaf_array(arr), dtype=np.dtype(dtype)).reshape(
            node.shape)

    return build(template, [])


def to_device(tree, device):
    """The same tree with every leaf a torch tensor on `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    arr = np.require(np.asarray(tree), requirements="CW")
    return torch.from_numpy(arr).to(device)


@dataclass
class CheckpointRecord:
    step: int
    image_id: str
    root: str
    stats: dict = field(default_factory=dict)


class CheckpointUploadError(RuntimeError):
    """A background checkpoint upload died. Raised from the next
    ``save()`` or ``wait()`` after the failure; the original exception
    is chained as ``__cause__``."""


class CheckpointManager:
    def __init__(self, store, gc, *, tenant: str, tenant_key: bytes,
                 run_name: str = "run", async_upload: bool = True,
                 chunk_size: int = 512 * 1024, l1=None, l2=None,
                 service=None, device="cuda"):
        self.store = store
        self.gc = gc
        self.tenant = tenant
        self.key = tenant_key
        self.run = run_name
        self.async_upload = async_upload
        self.chunk_size = chunk_size
        self.l1, self.l2 = l1, l2
        # optional ImageService: saves publish through the shared batched
        # write path; restores open through the shared read path
        self.service = service
        self.device = device          # the serial reader's, without one
        self.records: list[CheckpointRecord] = []
        self.last_snapshot_s = 0.0    # the latest save's host copy
        self._pending: threading.Thread | None = None
        self._failure: BaseException | None = None
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- save
    def save(self, step: int, state) -> None:
        """Snapshot to host, then upload (async by default). Raises
        ``CheckpointUploadError`` if the PREVIOUS async upload failed —
        before starting this one, so the failure maps to the earliest
        save after the loss, not the end of the run."""
        t0 = time.perf_counter()
        host_tree = state_to_tree(state)     # synchronous device->host copy
        self.last_snapshot_s = time.perf_counter() - t0
        if self._pending is not None:
            self._pending.join()             # backpressure: one in flight
        self._raise_pending_failure()
        t = threading.Thread(target=self._upload, args=(step, host_tree),
                             daemon=True)
        t.start()
        self._pending = t
        if not self.async_upload:
            t.join()
            self._raise_pending_failure()

    def _raise_pending_failure(self):
        with self._lock:
            err, self._failure = self._failure, None
        if err is not None:
            raise CheckpointUploadError(
                f"background checkpoint upload failed: {err!r}") from err

    def _upload(self, step: int, host_tree: dict):
        t0 = time.time()
        image_id = f"{self.run}-step{step:08d}"
        try:
            if self.service is not None:
                blob, stats = self.service.publish(
                    host_tree, tenant=self.tenant, tenant_key=self.key,
                    root=self.gc.active, image_id=image_id,
                    salt_epoch=getattr(self.gc, "epoch", 0),
                    chunk_size=self.chunk_size)
            else:
                blob, stats = create_image(
                    host_tree, tenant=self.tenant, tenant_key=self.key,
                    store=self.store, root=self.gc.active, image_id=image_id,
                    chunk_size=self.chunk_size)
            rec = CheckpointRecord(step, image_id, self.gc.active, {
                "unique_chunks": stats.unique_chunks,
                "dedup_chunks": stats.dedup_chunks,
                "zero_chunks": stats.zero_chunks,
                "bytes_uploaded": stats.bytes_uploaded,
                "bytes_total": stats.bytes_total,
                "seconds": time.time() - t0,
            })
            with self._lock:
                self.records.append(rec)
            COUNTERS.inc("ckpt.saves")
            # tiny metadata file for discovery
            self.store.put_manifest(self.gc.active, f"{image_id}.meta",
                                    json.dumps(rec.stats).encode())
        except BaseException as e:
            # a daemon thread's traceback otherwise evaporates: capture
            # and surface on the next save()/wait()
            with self._lock:
                self._failure = e
            COUNTERS.inc("ckpt.upload_failures")

    def wait(self):
        """Join the in-flight upload; raises ``CheckpointUploadError`` if
        it (or an earlier one) failed."""
        if self._pending is not None:
            self._pending.join()
        self._raise_pending_failure()

    # ------------------------------------------------------------- restore
    def latest(self) -> CheckpointRecord | None:
        self.wait()
        with self._lock:
            return self.records[-1] if self.records else None

    def reader(self, rec: CheckpointRecord):
        """A read session for `rec`: an ``ImageHandle`` through the
        shared service when one is attached (shared tiers, single-flight,
        GC pins), else the legacy private ``ImageReader`` shim — the two
        expose the same restore surface (``restore_tree`` / ``tensor``
        / ``restore_shards`` / ``tensor_shard`` / ``prefetch``)."""
        blob = self.store.get_manifest(rec.root, rec.image_id)
        if self.service is not None:
            return self.service.open(blob, self.key, root=rec.root)
        return ImageReader(blob, self.key, self.store, l1=self.l1, l2=self.l2,
                           root=rec.root, device=self.device)

    def restore(self, rec: CheckpointRecord, template):
        """Full restore into the structure of `template`."""
        r = self.reader(rec)
        flat = r.restore_tree()
        return tree_from_flat(template, flat)

    def restore_tensors(self, rec: CheckpointRecord, names: list) -> dict:
        """Demand restore of selected tensors only (shard-aware recovery)."""
        r = self.reader(rec)
        return {n: r.tensor(n) for n in names}

    def retire_before(self, keep_last: int = 1) -> set:
        """Retention policy: drop refcounts + manifests of all but the
        newest `keep_last` checkpoints (through ``gc.retire_image``).
        Returns the union of chunk names that went zero-referenced —
        reclaimed by the next ``gc.sweep(root)``. Requires a GC with the
        refcounted API and a service-published history; no-op
        otherwise."""
        self.wait()
        retire = getattr(self.gc, "retire_image", None)
        if retire is None:
            return set()
        with self._lock:
            old, keep = (self.records[:-keep_last],
                         self.records[-keep_last:]) if keep_last > 0 else \
                        (list(self.records), [])
            self.records = keep
        dead: set = set()
        for rec in old:
            dead |= retire(rec.root, rec.image_id)
            meta = f"{rec.image_id}.meta"
            if self.store.has_manifest(rec.root, meta):
                self.store.delete_manifest(rec.root, meta)
        return dead

    def discover(self, run: str | None = None) -> list:
        """Rebuild records from the store (cross-process restart path)."""
        run = run or self.run
        out = []
        for root in self.store.list_roots():
            for mid in self.store.list_manifests(root):
                if mid.startswith(run + "-step") and not mid.endswith(".meta"):
                    step = int(mid.split("step")[-1])
                    out.append(CheckpointRecord(step, mid, root))
        out.sort(key=lambda r: r.step)
        return out
