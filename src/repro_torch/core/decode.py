"""The decode stage of the fetch/decode restore pipeline, and the
decode-backend registry (the port of ``repro.core.decode``).

``TieredReader.fetch_ciphertexts`` (blockdev.py) only fetches; this
module turns a batch of ciphertexts into plaintexts, tile by tile, and
runs the same hooks forward for the publish path.

Backends — the registry. A backend pairs the batched AES block pass
(``encrypt_many``) with the batched SHA digest pass (``sha_many``) and,
optionally, a ``fused`` hook that yields (digests, plaintexts) in one
pass, together with the tile size and threading they want:

* ``"torch-fused"`` (alias ``"fused"``, and what ``"auto"`` resolves
  to): the fused verify+decrypt CUDA kernel on the read path, the SHA
  and AES kernels on the write path.
* ``"torch"``: two passes, the SHA kernel then the AES kernel.
* ``"python"`` (alias ``"numpy"``): numpy T-table AES + hashlib — the
  host oracle.
* ``"serial"``: the per-chunk ``decrypt_chunk`` oracle (not a registry
  object; it bypasses the batched pass).

The kernel hooks run on the decoder's ``device``: on ``"cuda"`` they
launch the kernels, on ``"cpu"`` the kernels' plain PyTorch versions.

Streaming (``decrypt_stream``) keeps the JAX package's contract: the
stream is drained even after a bad tile and one ``IntegrityError``
names every bad chunk; no plaintext of a bad chunk is returned; a
fetch-side failure (queue poisoned) is re-raised only after every
dispatched tile finished. With ``eager_flush`` the consumer also
dispatches its partial tile whenever it would block on an empty
hand-off queue, once the partial holds ``eager_min_bytes`` and no tile
is in flight (``stats["eager_flushes"]``/``["eager_holds"]``).

Tile sizing. ``max_batch_bytes="auto"`` (the ``ServiceConfig`` default)
asks ``autotune_tile_bytes`` for the backend's best tile: a timed sweep
at first use, cached per backend and device per process, one untimed
warmup per candidate, a budget that counts only timed runs;
``REPRO_NO_AUTOTUNE=1`` disables it and an explicit integer always
wins. The candidates are each backend's own. SHA-256 is serial within a
chunk, so a kernel launch costs at least one chunk's hash chain however
many chunks it holds, and its parallelism comes only from chunks per
launch: the kernel backends register 128 MiB tiles (256 chunks of
512 KiB) and sweep 8-256 MiB at the service's 512 KiB chunk. The host
work of a tile (packing, copies both ways, slicing the plaintexts)
does not fall with it: on an H100 the smallest of 32-256 MiB ran
fastest, so the sweep reaches down to 8 MiB, where the one chain a
launch costs sets the rate. The ``python`` backend keeps the JAX package's 64 KiB-1 MiB
candidates at 4 KiB chunks. On the CPU the kernel backends run their
plain versions, which are oracles and not worth tuning: there ``auto``
takes the registered tile.
"""
from __future__ import annotations

import functools
import os
import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.concurrency import QUEUE_DONE, QUEUE_EMPTY, LazyPool
from repro_torch.core.crypto import convergent
from repro_torch.core.layout import CHUNK_SIZE
from repro_torch.core.telemetry import COUNTERS

DEFAULT_MAX_BATCH_BYTES = 256 << 10
KERNEL_TILE_BYTES = 128 << 20
DEFAULT_THREADS = max(1, min(4, os.cpu_count() or 1))
DEFAULT_EAGER_MIN_BYTES = 32 << 10
# autotune candidates (module doc, "Tile sizing")
_TILE_CANDIDATES = (64 << 10, 128 << 10, 256 << 10, 512 << 10, 1 << 20)
KERNEL_TILE_CANDIDATES = (8 << 20, 16 << 20, 32 << 20, 64 << 20, 128 << 20,
                          256 << 20)


# ------------------------------------------------------------- registry

@dataclass
class DecodeBackend:
    """One named decode kernel set (module doc). ``loader(device)``
    returns ``(encrypt_many, sha_many, fused)`` with the hooks bound to
    `device`; ``None`` selects the numpy T-table core / hashlib / the
    two-pass route. ``threads=1`` means the kernel owns its
    parallelism. ``tile_candidates``, ``tune_chunk_bytes`` and
    ``tune_budget_s`` shape its autotune sweep; ``tunes_on_cpu=False``
    keeps the registered tile on the CPU (module doc). The
    ``encrypt_many``/``sha_many``/``fused`` properties are the hooks
    bound to the card (``"cuda"``, the port's default device);
    ``hooks("cpu")`` binds them to the plain versions."""

    name: str
    description: str
    tile_bytes: int = DEFAULT_MAX_BATCH_BYTES
    threads: int | None = None
    loader: object = None
    tile_candidates: tuple = _TILE_CANDIDATES
    tune_chunk_bytes: int = 4096
    tune_budget_s: float = 0.25
    tunes_on_cpu: bool = True
    _hooks: dict = field(default_factory=dict, init=False, repr=False)

    def hooks(self, device="cuda") -> tuple:
        key = str(device)
        if key not in self._hooks:
            self._hooks[key] = self.loader(device) if self.loader \
                else (None, None, None)
        return self._hooks[key]

    @property
    def encrypt_many(self):
        return self.hooks()[0]

    @property
    def sha_many(self):
        return self.hooks()[1]

    @property
    def fused(self):
        return self.hooks()[2]


_REGISTRY: dict[str, DecodeBackend] = {}
_ALIASES: dict[str, str] = {}


def register_backend(backend: DecodeBackend, aliases: tuple = ()) -> None:
    _REGISTRY[backend.name] = backend
    for a in aliases:
        _ALIASES[a] = backend.name


def registered_backends() -> dict:
    """{canonical name: DecodeBackend}, registration order."""
    return dict(_REGISTRY)


def known_backend_names() -> list:
    """Every name ``BatchDecoder``/``ReadPolicy`` accept."""
    return sorted(set(_REGISTRY) | set(_ALIASES) | {"serial", "auto"})


def resolve_backend_name(name: str) -> str:
    """Canonical registry name for `name` (aliases and ``"auto"``
    resolved; ``"serial"`` passes through). Raises ``ValueError`` on
    unknowns."""
    if name == "serial":
        return "serial"
    if name == "auto":
        return "torch-fused"
    name = _ALIASES.get(name, name)
    if name not in _REGISTRY:
        raise ValueError(f"unknown decode backend {name!r}; known: "
                         f"{known_backend_names()}")
    return name


def get_backend(name: str) -> DecodeBackend:
    """The registered backend object behind `name` (not ``"serial"``)."""
    return _REGISTRY[resolve_backend_name(name)]


def _bind(fn, device):
    bound = functools.partial(fn, device=device)
    bound.per_chunk_rks = getattr(fn, "per_chunk_rks", False)
    return bound


def _load_torch(device):
    from repro_torch.kernels.aes import encrypt_many
    from repro_torch.kernels.sha256 import sha256_many
    return _bind(encrypt_many, device), _bind(sha256_many, device), None


def _load_torch_fused(device):
    from repro_torch.kernels.fused import fused_verify_decrypt
    enc, sha, _ = _load_torch(device)
    return enc, sha, _bind(fused_verify_decrypt, device)


register_backend(DecodeBackend(
    "python", "batched numpy T-table AES + hashlib verify (host "
    "oracle)"), aliases=("numpy",))
# the kernel backends' sweep: its timed passes take about a second in
# all with their host copies, so the budget admits every candidate
_KERNEL_TUNING = dict(tile_bytes=KERNEL_TILE_BYTES, threads=1,
                      tile_candidates=KERNEL_TILE_CANDIDATES,
                      tune_chunk_bytes=CHUNK_SIZE, tune_budget_s=2.0,
                      tunes_on_cpu=False)
register_backend(DecodeBackend(
    "torch", "two passes: the SHA-256 kernel, then the AES-CTR kernel",
    loader=_load_torch, **_KERNEL_TUNING))
register_backend(DecodeBackend(
    "torch-fused", "ONE fused verify+decrypt kernel on the read path; "
    "the SHA-256 and AES kernels on the write path",
    loader=_load_torch_fused, **_KERNEL_TUNING), aliases=("fused",))


# ------------------------------------------------------------- autotune

_AUTOTUNE_CACHE: dict[tuple, int] = {}
_AUTOTUNE_LOCK = threading.Lock()
# (backend, device kind) -> Event while its sweep runs: the lock guards
# only the cache and pending dicts, never a measurement, so one
# backend's first sweep does not hold up any other backend's first
# decode (only callers of the same backend wait, on the event)
_AUTOTUNE_PENDING: dict[tuple, threading.Event] = {}
# (backend, device kind) -> {candidate bytes: timed bytes/s} of the
# last sweep
AUTOTUNE_RATES: dict[tuple, dict] = {}


def _autotune_sweep(backend, *, device, budget_s: float,
                    chunk_bytes: int) -> tuple:
    """The timed candidate sweep (no lock held): ``(best tile,
    {candidate: bytes/s})``. Each candidate gets ONE untimed warmup call
    first (kernel builds, first-touch allocations), and only the timed
    run counts toward the rate and ``budget_s``, checked before each
    candidate's warmup."""
    import numpy as np

    from repro_torch.core.crypto import aes

    enc, sha, fused = backend.hooks(device)
    rng = np.random.default_rng(0xA070)
    candidates = [backend.tile_bytes] + [
        c for c in backend.tile_candidates if c != backend.tile_bytes]
    most = max(1, max(candidates) // chunk_bytes)
    pool = rng.bytes(most * chunk_bytes)
    keys_all = [rng.bytes(32) for _ in range(most)]

    def one_pass(cts, keys):
        if fused is not None:
            fused(cts, keys)
            return
        if sha is not None:
            sha(cts)
        else:
            import hashlib
            for ct in cts:
                hashlib.sha256(ct).digest()
        aes.ctr_keystream_many(keys, [len(ct) for ct in cts],
                               encrypt_many=enc)

    best, best_rate, spent, rates = backend.tile_bytes, 0.0, 0.0, {}
    for cand in candidates:
        if spent > budget_s:    # checked BEFORE the warmup: an exhausted
            break               # budget starts no further candidate
        nchunks = max(1, cand // chunk_bytes)
        cts = [pool[i * chunk_bytes:(i + 1) * chunk_bytes]
               for i in range(nchunks)]
        keys = keys_all[:nchunks]
        one_pass(cts, keys)     # warmup, untimed
        t0 = time.perf_counter()
        one_pass(cts, keys)
        dt = time.perf_counter() - t0
        rates[cand] = rate = nchunks * chunk_bytes / max(dt, 1e-9)
        if rate > best_rate:
            best_rate, best = rate, cand
        spent += dt
    return best, rates


def autotune_tile_bytes(backend_name: str, *, device="cuda",
                        budget_s: float | None = None,
                        chunk_bytes: int | None = None,
                        force: bool = False) -> int:
    """Best ``max_batch_bytes`` for `backend_name` on `device` in THIS
    process: a timed sweep over the backend's tile candidates at first
    use, cached per (backend, device kind). Each candidate decodes one
    synthetic tile of ``chunk_bytes`` chunks (default: the backend's
    ``tune_chunk_bytes``) through the backend's real combined pass (the
    fused hook when present, else verify + keystream); the highest
    bytes/s wins. Candidates start from the registered tile, and once
    ``budget_s`` (default: the backend's ``tune_budget_s``) of timed
    runs has elapsed no further candidate starts.

    The sweep runs outside ``_AUTOTUNE_LOCK``: concurrent callers of the
    same backend wait on its pending event, other backends sweep or
    read their cached tile meanwhile. ``REPRO_NO_AUTOTUNE=1`` (env)
    disables the sweep, as does the CPU for a backend with
    ``tunes_on_cpu=False``; both return the registered tile.
    ``force=True`` re-measures."""
    resolved = resolve_backend_name(backend_name)
    if resolved == "serial":
        return DEFAULT_MAX_BATCH_BYTES
    backend = _REGISTRY[resolved]
    kind = str(device).split(":", 1)[0]         # "cuda:0" -> "cuda"
    if os.environ.get("REPRO_NO_AUTOTUNE") or \
            (kind == "cpu" and not backend.tunes_on_cpu):
        return backend.tile_bytes
    key = (resolved, kind)
    while True:
        with _AUTOTUNE_LOCK:
            if not force and key in _AUTOTUNE_CACHE:
                return _AUTOTUNE_CACHE[key]
            pending = _AUTOTUNE_PENDING.get(key)
            if pending is None:
                pending = _AUTOTUNE_PENDING[key] = threading.Event()
                break               # this caller runs the sweep
        pending.wait()              # a same-backend sweep is in flight
        with _AUTOTUNE_LOCK:
            done = _AUTOTUNE_CACHE.get(key)
        if done is not None and not force:
            return done
        # that sweep failed (or force=True): claim it ourselves
    try:
        best, rates = _autotune_sweep(
            backend, device=device,
            budget_s=backend.tune_budget_s if budget_s is None
            else budget_s,
            chunk_bytes=chunk_bytes or backend.tune_chunk_bytes)
        with _AUTOTUNE_LOCK:
            _AUTOTUNE_CACHE[key] = best
            AUTOTUNE_RATES[key] = rates
        COUNTERS.inc("decode.autotuned_backends")
        return best
    finally:
        with _AUTOTUNE_LOCK:
            _AUTOTUNE_PENDING.pop(key, None)
        pending.set()


class BatchDecoder:
    """Decodes {name: ciphertext} batches against manifest ChunkRefs,
    and encrypts chunk batches for publish, on `device`."""

    def __init__(self, backend: str = "torch-fused",
                 max_batch_bytes: int | str | None = None,
                 threads: int | None = None, eager_flush: bool = False,
                 eager_min_bytes: int | None = None, device="cuda"):
        resolved = resolve_backend_name(backend)     # raises on unknowns
        self.backend = resolved if backend == "auto" else backend
        self.backend_obj = _REGISTRY.get(resolved)   # None for "serial"
        self.device = device
        self.eager_flush = bool(eager_flush)
        self.eager_min_bytes = DEFAULT_EAGER_MIN_BYTES \
            if eager_min_bytes is None else max(0, int(eager_min_bytes))
        if max_batch_bytes == "auto":
            # measured per backend per process; explicit ints always win
            max_batch_bytes = autotune_tile_bytes(resolved, device=device) \
                if self.backend_obj else DEFAULT_MAX_BATCH_BYTES
        elif max_batch_bytes is None:                # backend default
            max_batch_bytes = self.backend_obj.tile_bytes \
                if self.backend_obj else DEFAULT_MAX_BATCH_BYTES
        self.max_batch_bytes = max(1, int(max_batch_bytes))
        self.threads = DEFAULT_THREADS if threads is None else max(1, threads)
        self._encrypt_many = self._sha_many = self._fused = None
        if self.backend_obj is not None:
            (self._encrypt_many, self._sha_many,
             self._fused) = self.backend_obj.hooks(device)
            if self.backend_obj.threads is not None:
                self.threads = self.backend_obj.threads  # kernel's own
        self._pool = LazyPool()
        self.last_wall_s = 0.0

    def decrypt_batch(self, refs: list, ciphertexts: dict) -> dict:
        """refs: ChunkRefs (one per distinct name); ciphertexts:
        {name: bytes}. Returns {name: plaintext}; tampered ciphertexts
        raise ``IntegrityError`` naming every offending chunk."""
        out, self.last_wall_s = self.decrypt_batch_timed(refs, ciphertexts)
        return out

    def decrypt_batch_timed(self, refs: list, ciphertexts: dict) -> tuple:
        """``decrypt_batch`` returning ({name: plaintext}, wall_seconds)."""
        t0 = time.perf_counter()
        out: dict[str, bytes] = {}
        bad_names: list[str] = []
        if self.backend == "serial":
            for ref in refs:
                try:
                    out[ref.name] = convergent.decrypt_chunk(
                        ciphertexts[ref.name], ref.key, ref.sha256)
                except convergent.IntegrityError:
                    bad_names.append(ref.name)
        else:
            tiles = list(self._split(refs, ciphertexts))
            if len(tiles) > 1 and self.threads > 1:
                results = list(self._pool.get(self.threads).map(
                    lambda t: self._decode_tile(t, ciphertexts), tiles))
            else:
                results = [self._decode_tile(t, ciphertexts) for t in tiles]
            for plains, bad in results:
                out.update(plains)
                bad_names.extend(bad)
        if bad_names:
            raise convergent.IntegrityError(
                f"chunk ciphertext hash mismatch: {sorted(bad_names)}",
                sorted(bad_names))
        COUNTERS.add("decode.batched_chunks", len(out))
        return out, time.perf_counter() - t0

    def decrypt_stream(self, queue, refs_by_name: dict) -> tuple:
        """Streaming consumer: drain ``(name, ciphertext)`` pairs from a
        ``BoundedQueue``, accumulating ``max_batch_bytes`` tiles and
        decoding each while the fetch producer is still running.

        Returns ``({name: plaintext}, stats)`` with ``busy_s`` (summed
        decode time), ``wall_s``, ``tiles``, ``eager_flushes`` and
        ``eager_holds``. The stream is drained even after a bad tile;
        one ``IntegrityError`` then names every bad chunk, and no bad
        chunk's plaintext is returned. A poisoned queue re-raises the
        producer's error after every dispatched tile finished.

        With ``eager_flush`` the partial tile is dispatched whenever the
        queue is momentarily empty (``try_get`` returns
        ``QUEUE_EMPTY``), it holds at least ``eager_min_bytes`` and no
        dispatched tile is still running."""
        t0 = time.perf_counter()
        out: dict[str, bytes] = {}
        bad_names: list[str] = []
        results: list = []
        futures: list = []
        pool = self._pool.get(self.threads) \
            if self.backend != "serial" and self.threads > 1 else None
        part: list = []
        cts: dict[str, bytes] = {}
        size = 0
        busy_inline = 0.0
        eager = self.eager_flush and self.backend != "serial"
        eager_flushes = eager_holds = 0

        def flush():
            nonlocal part, cts, size
            if not part:
                return
            if pool is not None:
                futures.append(pool.submit(self._decode_tile_timed, part, cts))
            else:
                results.append(self._decode_tile_timed(part, cts))
            part, cts, size = [], {}, 0

        stream_err = None
        try:
            while True:
                if eager and part:
                    item = queue.try_get()
                    if item is QUEUE_EMPTY:
                        # the consumer would block here: flush the
                        # partial tile only if it is no sliver and the
                        # decode capacity is idle (with tiles in flight
                        # an early flush only shreds tiles)
                        if size < self.eager_min_bytes:
                            eager_holds += 1
                            COUNTERS.inc("decode.eager_holds")
                        elif pool is None or all(f.done() for f in futures):
                            flush()
                            eager_flushes += 1
                            COUNTERS.inc("decode.eager_flushes")
                        item = queue.get()
                else:
                    item = queue.get()
                if item is QUEUE_DONE:
                    break
                name, ct = item
                ref = refs_by_name[name]
                if self.backend == "serial":
                    ts = time.perf_counter()
                    try:
                        out[ref.name] = convergent.decrypt_chunk(
                            ct, ref.key, ref.sha256)
                    except convergent.IntegrityError:
                        bad_names.append(ref.name)
                    busy_inline += time.perf_counter() - ts
                    continue
                if part and size + len(ct) > self.max_batch_bytes:
                    flush()
                part.append(ref)
                cts[name] = ct
                size += len(ct)
        except BaseException as e:
            stream_err = e
        else:
            flush()
        tile_err = None
        for f in futures:
            try:
                results.append(f.result())
            except BaseException as e:
                if tile_err is None:
                    tile_err = e
        busy = busy_inline
        for plains, bad, tile_wall in results:
            out.update(plains)
            bad_names.extend(bad)
            busy += tile_wall
        if stream_err is not None:          # fetch failure dominates
            raise stream_err
        if tile_err is not None:
            raise tile_err
        if bad_names:
            raise convergent.IntegrityError(
                f"chunk ciphertext hash mismatch: {sorted(bad_names)}",
                sorted(bad_names))
        COUNTERS.add("decode.batched_chunks", len(out))
        return out, {"busy_s": busy, "wall_s": time.perf_counter() - t0,
                     "tiles": len(results), "eager_flushes": eager_flushes,
                     "eager_holds": eager_holds}

    # --------------------------------------------------- forward direction
    def derive_keys_batch(self, plaintexts: list, salt: bytes) -> list:
        """Batched convergent key derivation through the SHA hook."""
        if self.backend == "serial":
            return [convergent.derive_key(p, salt) for p in plaintexts]
        return convergent.derive_keys(plaintexts, salt,
                                      sha_many=self._sha_many)

    def encrypt_batch_timed(self, plaintexts: list, salt: bytes, *,
                            keys: list | None = None) -> tuple:
        """Batched convergent encryption of N chunks through the same
        hooks, tiled by ``max_batch_bytes``: (``EncryptedChunk`` list in
        input order, wall_seconds), byte-identical to the serial
        ``convergent.encrypt_chunk`` oracle. `keys` carries keys already
        derived by ``derive_keys_batch``."""
        t0 = time.perf_counter()
        pts = list(plaintexts)
        if not pts:
            return [], 0.0
        if self.backend == "serial":
            out = [convergent.encrypt_chunk(p, salt) for p in pts]
            return out, time.perf_counter() - t0
        if keys is None:
            keys = self.derive_keys_batch(pts, salt)
        tiles = list(self._split_forward(pts, keys))
        if len(tiles) > 1 and self.threads > 1:
            results = list(self._pool.get(self.threads).map(
                lambda t: self._forward_tile(t[0], salt, t[1]), tiles))
        else:
            results = [self._forward_tile(p, salt, k) for p, k in tiles]
        out = [enc for tile in results for enc in tile]
        COUNTERS.add("decode.forward_chunks", len(out))
        return out, time.perf_counter() - t0

    def _forward_tile(self, pts: list, salt: bytes, keys: list) -> list:
        return convergent.encrypt_chunks(
            pts, salt, keys=keys, encrypt_many=self._encrypt_many,
            sha_many=self._sha_many)

    def _split_forward(self, pts: list, keys: list):
        """(plaintexts, keys) tiles under ``max_batch_bytes`` each."""
        part, pkeys, size = [], [], 0
        for p, k in zip(pts, keys):
            if part and size + len(p) > self.max_batch_bytes:
                yield part, pkeys
                part, pkeys, size = [], [], 0
            part.append(p)
            pkeys.append(k)
            size += len(p)
        if part:
            yield part, pkeys

    def close(self):
        """Drain the tile pool (idempotent)."""
        self._pool.shutdown()

    def _decode_tile_timed(self, part: list, ciphertexts: dict) -> tuple:
        t0 = time.perf_counter()
        plains, bad = self._decode_tile(part, ciphertexts)
        return plains, bad, time.perf_counter() - t0

    def _decode_tile(self, part: list, ciphertexts: dict) -> tuple:
        """One tile through the batched verify+decrypt pass. Returns
        ({name: plaintext}, [tampered names])."""
        cts = [ciphertexts[r.name] for r in part]
        try:
            plains = convergent.decrypt_chunks(
                cts, [r.key for r in part], [r.sha256 for r in part],
                encrypt_many=self._encrypt_many, sha_many=self._sha_many,
                fused=self._fused)
        except convergent.IntegrityError as e:
            return {}, [part[i].name for i in e.bad_positions]
        return {r.name: p for r, p in zip(part, plains)}, []

    def _split(self, refs: list, ciphertexts: dict):
        """Tiles under ``max_batch_bytes`` of ciphertext each."""
        part: list = []
        size = 0
        for ref in refs:
            n = len(ciphertexts[ref.name])
            if part and size + n > self.max_batch_bytes:
                yield part
                part, size = [], 0
            part.append(ref)
            size += n
        if part:
            yield part
