"""The plain reference of the write path: what a published image must
hold, worked out from the tree the benchmark handed to the program.

The scheme is the paper's (§3.1-3.3): tensors in sorted path order, each
at a chunk-aligned offset, zero-padded; each chunk's key is
SHA-256(salt || plaintext), its ciphertext AES-256-CTR under that key
with a zero IV, its name the hex SHA-256 of the ciphertext; an all-zero
chunk is elided under ``ZERO_NAME``; the manifest is MessagePack, its key
table sealed with AES-GCM under the tenant key. The reference uses numpy,
hashlib and the benchmark's own AES and MessagePack decoder, and nothing
of the program: it reads the manifest blob and the origin's chunk files,
which both sides see, and judges them.
"""
from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from benchkit import aes_ref, msgpack_ref

ZERO_NAME = "__zero__"


def salt(epoch: int, root: str, placement: str = "") -> bytes:
    """The dedup salt of a root and epoch (§3.3)."""
    return hashlib.sha256(b"repro-salt|%d|%s|%s" % (
        epoch, root.encode(), placement.encode())).digest()[:16]


def leaves(tree: dict) -> list:
    """(name, C-contiguous numpy array) of a flat tree, in sorted path
    order."""
    return [(k, np.ascontiguousarray(tree[k])) for k in sorted(tree)]


def layout(tree: dict, chunk_size: int) -> tuple:
    """([name, offset, nbytes, dtype, shape] per tensor, image size)."""
    table, off = [], 0
    for name, a in leaves(tree):
        table.append([name, off, a.nbytes, str(a.dtype), list(a.shape)])
        off += -(-a.nbytes // chunk_size) * chunk_size
    return table, max(off, chunk_size)


def chunks(tree: dict, chunk_size: int):
    """(index, plaintext bytes) of every chunk of the image."""
    idx = 0
    for _, a in leaves(tree):
        raw = a.reshape(-1).view(np.uint8)
        for c in range(-(-raw.nbytes // chunk_size)):
            win = raw[c * chunk_size:(c + 1) * chunk_size].tobytes()
            yield idx, win + b"\x00" * (chunk_size - len(win))
            idx += 1
    if idx == 0:
        yield 0, b"\x00" * chunk_size


def image_id(tree: dict) -> str:
    h = hashlib.sha256()
    for name, a in leaves(tree):
        h.update(name.encode())
        h.update(a.reshape(-1).view(np.uint8).data)
    return h.hexdigest()[:32]


def chunk_path(store_dir, root: str, name: str) -> Path:
    """Where the origin keeps a chunk (``roots/<root>/chunks/<aa>/<name>``)."""
    return Path(store_dir) / "roots" / root / "chunks" / name[:2] / name


def distinct_chunks(tree: dict, chunk_size: int) -> int:
    """Distinct non-zero chunk plaintexts of the image: what a cold
    start with empty tiers fetches and decodes."""
    seen = set()
    for _, pt in chunks(tree, chunk_size):
        if pt.count(0) != len(pt):
            seen.add(hashlib.sha256(pt).digest())
    return len(seen)


def check_image(blob: bytes, tenant_key: bytes, tree: dict, *, store_dir,
                root: str, tenant: str, chunk_size: int, epoch: int = 0,
                sample: list = ()) -> dict:
    """Counts of what differs between a published image and the
    reference: ``manifest`` fields (id, tenant, root, salt, sizes, the
    layout table, the chunk count), ``chunks`` whose name, digest, key
    or stored ciphertext differ, and ``ciphertexts`` among the `sample`
    chunk indices whose stored bytes are not the reference's own
    AES-256-CTR of the plaintext. All three are 0 for a sound image."""
    outer = msgpack_ref.unpack(blob)
    pub = msgpack_ref.unpack(outer["body"])
    s = salt(epoch, root)
    table, size = layout(tree, chunk_size)
    want = {"image_id": image_id(tree), "tenant": tenant, "root_id": root,
            "salt": s, "chunk_size": chunk_size, "image_size": size,
            "layout": table}
    bad = {"manifest": sum(pub.get(k) != v for k, v in want.items()),
           "chunks": 0, "ciphertexts": 0}
    refs = pub.get("chunks", [])
    if len(refs) != size // chunk_size:
        bad["manifest"] += 1
    keys = aes_ref.gcm_ctr_xor(outer["key_ct"], tenant_key, outer["nonce"])
    sample = set(sample)
    for i, pt in chunks(tree, chunk_size):
        if i >= len(refs):
            bad["chunks"] += 1
            continue
        idx, name, digest = refs[i]
        got_key = keys[32 * i:32 * (i + 1)]
        if pt.count(0) == len(pt):
            bad["chunks"] += (idx, name, got_key) != (i, ZERO_NAME,
                                                      b"\x00" * 32)
            continue
        key = hashlib.sha256(s + pt).digest()
        try:
            ct = chunk_path(store_dir, root, name).read_bytes()
        except (OSError, TypeError):
            bad["chunks"] += 1
            continue
        d = hashlib.sha256(ct).digest()
        bad["chunks"] += (idx != i or name != d.hex() or digest != d
                          or got_key != key or len(ct) != len(pt))
        if i in sample and ct != aes_ref.ctr_xor(pt, key):
            bad["ciphertexts"] += 1
    return bad
