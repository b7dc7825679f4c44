"""Chunk manifest (paper §3.1): binary (msgpack), with ONLY the key table
encrypted (AES-GCM, per-tenant key) and the whole document authenticated —
the GC can read the chunk list without any access to chunk keys.

Layout of the serialized blob:
  msgpack{ body: bytes(msgpack of public part), nonce, key_ct, tag }
  tag = AES-GCM(tenant_key, nonce; plaintext=key_table, aad=body)
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

from repro_torch.core import _msgpack as msgpack
from repro_torch.core.crypto import aes

ZERO_CHUNK = "__zero__"          # elided all-zero chunk sentinel (§3.2)


@dataclass
class ChunkRef:
    index: int                   # chunk index within the image
    name: str                    # ciphertext hash (hex) or ZERO_CHUNK
    key: bytes = b""             # 32B convergent key (private)
    sha256: bytes = b""          # ciphertext digest (public, integrity)


@dataclass
class Manifest:
    image_id: str
    tenant: str
    root_id: str
    salt: bytes
    chunk_size: int
    image_size: int
    layout_table: list           # ImageLayout.to_table()
    chunks: list = field(default_factory=list)   # list[ChunkRef]

    @property
    def unique_names(self) -> list:
        return sorted({c.name for c in self.chunks if c.name != ZERO_CHUNK})

    def public_body(self) -> dict:
        return {
            "image_id": self.image_id,
            "tenant": self.tenant,
            "root_id": self.root_id,
            "salt": self.salt,
            "chunk_size": self.chunk_size,
            "image_size": self.image_size,
            "layout": self.layout_table,
            "chunks": [[c.index, c.name, c.sha256] for c in self.chunks],
        }


def seal(manifest: Manifest, tenant_key: bytes, nonce: bytes | None = None) -> bytes:
    body = msgpack.packb(manifest.public_body(), use_bin_type=True)
    key_table = b"".join(c.key if c.name != ZERO_CHUNK else b"\x00" * 32
                         for c in manifest.chunks)
    nonce = nonce or os.urandom(12)
    ct, tag = aes.gcm_encrypt(tenant_key, nonce, key_table, aad=body)
    return msgpack.packb({"body": body, "nonce": nonce, "key_ct": ct,
                          "tag": tag}, use_bin_type=True)


def read_public(blob: bytes) -> dict:
    """GC-side read: chunk list + layout, NO keys, NO tenant key needed."""
    outer = msgpack.unpackb(blob, raw=False)
    return msgpack.unpackb(outer["body"], raw=False)


def open_manifest(blob: bytes, tenant_key: bytes) -> Manifest:
    """Worker-side open: authenticates the whole document, decrypts keys."""
    outer = msgpack.unpackb(blob, raw=False)
    body = outer["body"]
    key_table = aes.gcm_decrypt(tenant_key, outer["nonce"], outer["key_ct"],
                                outer["tag"], aad=body)
    pub = msgpack.unpackb(body, raw=False)
    chunks = []
    for i, (idx, name, sha) in enumerate(pub["chunks"]):
        key = key_table[32 * i:32 * (i + 1)]
        chunks.append(ChunkRef(idx, name, key if name != ZERO_CHUNK else b"",
                               sha))
    return Manifest(
        image_id=pub["image_id"], tenant=pub["tenant"], root_id=pub["root_id"],
        salt=pub["salt"], chunk_size=pub["chunk_size"],
        image_size=pub["image_size"], layout_table=pub["layout"],
        chunks=chunks)
