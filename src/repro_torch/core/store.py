"""Content-addressed origin store with generational roots (S3 stand-in;
the port of ``repro.core.store``).

Chunks live under ``<dir>/roots/<root_id>/chunks/<aa>/<name>``,
manifests under ``.../manifests/<image_id>`` and a root's lifecycle
state in ``.../STATE``, as in the JAX package, so either package reads
a store (and its root states) the other wrote. The only chunk write
primitive is PUT-if-absent (paper §3.1: flattening processes need no
coordination). Reads on *expired* roots raise an alarm and freeze
deletion (§3.4).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

from repro_torch.core.telemetry import COUNTERS


class ExpiredRootRead(Exception):
    pass


class ChunkStore:
    def __init__(self, root_dir, fsync: bool = False):
        self.dir = Path(root_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self._alarm_cbs = []
        self.deletion_frozen = False
        self.scrubbed_tmp = self._scrub_orphans()

    def _scrub_orphans(self) -> int:
        """Startup torn-write recovery: a crash between the temp create
        and the atomic link/replace (``put_if_absent`` / ``_write``)
        leaves ``*.tmp-<tid>`` orphans. They are never addressable —
        chunk names are content hashes — so any survivor is garbage;
        scrub them before serving."""
        base = self.dir / "roots"
        if not base.exists():
            return 0
        n = 0
        for pattern in ("*/chunks/*/*.tmp-*", "*/manifests/*.tmp-*",
                        "*/STATE.tmp-*"):
            for tmp in base.glob(pattern):
                try:
                    tmp.unlink()
                    n += 1
                except FileNotFoundError:
                    pass
        if n:
            COUNTERS.add("store.torn_writes_scrubbed", n)
        return n

    # ------------------------------------------------------------ helpers
    def _chunk_path(self, root: str, name: str) -> Path:
        return self.dir / "roots" / root / "chunks" / name[:2] / name

    def _manifest_path(self, root: str, image_id: str) -> Path:
        return self.dir / "roots" / root / "manifests" / image_id

    def _state_path(self, root: str) -> Path:
        return self.dir / "roots" / root / "STATE"

    def _write_tmp(self, path: Path, data: bytes) -> Path:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp-%d" % threading.get_ident())
        with open(tmp, "wb") as f:
            f.write(data)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        return tmp

    def _write(self, path: Path, data: bytes):
        os.replace(self._write_tmp(path, data), path)

    def _check_deletable(self):
        if self.deletion_frozen:
            raise RuntimeError("deletions frozen by expired-root read alarm")

    # -------------------------------------------------------------- roots
    def create_root(self, root: str):
        self._set_state(root, "active")

    def _set_state(self, root: str, state: str):
        self._write(self._state_path(root),
                    json.dumps({"state": state}).encode())

    def root_state(self, root: str) -> str:
        p = self._state_path(root)
        if not p.exists():
            return "absent"
        return json.loads(p.read_text())["state"]

    def list_roots(self) -> list:
        base = self.dir / "roots"
        return sorted(p.name for p in base.iterdir()) if base.exists() else []

    def on_expired_read(self, cb):
        self._alarm_cbs.append(cb)

    def _check_read(self, root: str):
        """The §3.4 alarm: a read of an expired root counts, freezes
        every later deletion and calls each registered callback."""
        if self.root_state(root) == "expired":
            COUNTERS.inc("store.expired_root_reads")
            self.deletion_frozen = True
            for cb in self._alarm_cbs:
                cb(root)

    # -------------------------------------------------------------- chunks
    def put_if_absent(self, root: str, name: str, data: bytes) -> bool:
        """Returns True if the chunk was new (uploaded).

        Atomic: the fully-written temp file is *linked* into place
        (``os.link`` fails with EEXIST if the name is taken), so two
        concurrent publishers of the same chunk cannot both claim the
        upload and a reader never observes a partially-written chunk."""
        path = self._chunk_path(root, name)
        if path.exists():                    # cheap fast path, not the claim
            COUNTERS.inc("store.dedup_hits")
            return False
        tmp = self._write_tmp(path, data)
        try:
            os.link(tmp, path)               # atomic claim: EEXIST if lost
        except FileExistsError:
            COUNTERS.inc("store.dedup_hits")
            return False
        finally:
            os.unlink(tmp)
        COUNTERS.inc("store.chunks_uploaded")
        COUNTERS.add("store.bytes_uploaded", len(data))
        return True

    def has_chunk(self, root: str, name: str) -> bool:
        return self._chunk_path(root, name).exists()

    def has_chunks(self, root: str, names: list) -> set:
        """Batched presence probe: the subset of `names` present in
        `root` (one call per publish stage batch, the analogue of one
        batched HEAD round)."""
        COUNTERS.inc("store.presence_probes")
        base = self.dir / "roots" / root / "chunks"
        return {n for n in names if (base / n[:2] / n).exists()}

    def get_chunk(self, root: str, name: str) -> bytes:
        self._check_read(root)
        COUNTERS.inc("store.chunk_gets")
        return self._chunk_path(root, name).read_bytes()

    def list_chunks(self, root: str) -> list:
        base = self.dir / "roots" / root / "chunks"
        if not base.exists():
            return []
        return sorted(p.name for sub in base.iterdir() for p in sub.iterdir())

    def delete_chunk(self, root: str, name: str):
        self._check_deletable()
        p = self._chunk_path(root, name)
        if p.exists():
            p.unlink()

    # ----------------------------------------------------------- manifests
    def put_manifest(self, root: str, image_id: str, blob: bytes):
        self._write(self._manifest_path(root, image_id), blob)

    def get_manifest(self, root: str, image_id: str) -> bytes:
        self._check_read(root)
        return self._manifest_path(root, image_id).read_bytes()

    def has_manifest(self, root: str, image_id: str) -> bool:
        return self._manifest_path(root, image_id).exists()

    def list_manifests(self, root: str) -> list:
        base = self.dir / "roots" / root / "manifests"
        return sorted(p.name for p in base.iterdir()) if base.exists() else []

    def delete_manifest(self, root: str, image_id: str):
        self._check_deletable()
        p = self._manifest_path(root, image_id)
        if p.exists():
            p.unlink()

    def delete_root(self, root: str):
        self._check_deletable()
        shutil.rmtree(self.dir / "roots" / root, ignore_errors=True)
