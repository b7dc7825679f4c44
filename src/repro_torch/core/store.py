"""Content-addressed origin store (S3 stand-in; the copy of
``repro.core.store`` without the generational-root states, listings and
deletions that the GC of a later slice needs).

Chunks live under ``<dir>/roots/<root_id>/chunks/<aa>/<name>`` and
manifests under ``.../manifests/<image_id>``, as in the JAX package, so
either package reads a store the other wrote. The only chunk write
primitive is PUT-if-absent (paper §3.1: flattening processes need no
coordination).
"""
from __future__ import annotations

import os
import threading
from pathlib import Path

from repro_torch.core.telemetry import COUNTERS


class ChunkStore:
    def __init__(self, root_dir, fsync: bool = False):
        self.dir = Path(root_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
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

    def _write_tmp(self, path: Path, data: bytes) -> Path:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp-%d" % threading.get_ident())
        with open(tmp, "wb") as f:
            f.write(data)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        return tmp

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

    def get_chunk(self, root: str, name: str) -> bytes:
        COUNTERS.inc("store.chunk_gets")
        return self._chunk_path(root, name).read_bytes()

    # ----------------------------------------------------------- manifests
    def put_manifest(self, root: str, image_id: str, blob: bytes):
        path = self._manifest_path(root, image_id)
        os.replace(self._write_tmp(path, blob), path)
