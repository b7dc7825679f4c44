"""Convergent encryption (paper §3.1) with blast-radius salt (§3.3).

key   = SHA256(salt ‖ plaintext)            (Farsite-style, salted)
ct    = AES256-CTR(key, IV=0, plaintext)    (zero IV safe: one key ↔ one pt)
name  = SHA256(ct)                          (content-addressed ciphertext)

The salt varies with time / popularity / placement / GC root; identical
plaintexts under the same salt deduplicate, different salts isolate blast
radius. SHA256 (not a data-key AEAD) is used for integrity because AEADs
don't provide collision resistance against attackers who know the key
(paper footnote 2 / invisible-salamanders).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.crypto import aes
from repro_torch.core.crypto.sha256v import sha256_many


def derive_key(plaintext: bytes, salt: bytes) -> bytes:
    return hashlib.sha256(salt + plaintext).digest()


def chunk_name(ciphertext: bytes) -> str:
    return hashlib.sha256(ciphertext).hexdigest()


@dataclass(frozen=True)
class EncryptedChunk:
    name: str
    ciphertext: bytes
    key: bytes          # goes into the manifest's (encrypted) key table
    sha256: bytes       # of ciphertext: end-to-end integrity check


def encrypt_chunk(plaintext: bytes, salt: bytes) -> EncryptedChunk:
    key = derive_key(plaintext, salt)
    ct = aes.ctr_encrypt(plaintext, key)
    digest = hashlib.sha256(ct).digest()
    return EncryptedChunk(name=digest.hex(), ciphertext=ct, key=key,
                          sha256=digest)


def derive_keys(plaintexts: list, salt: bytes, *, sha_many=None) -> list:
    """Batched convergent key derivation: SHA256(salt ‖ pt) for N chunks
    in one digest pass (``sha256v.sha256_many``; a ``sha_many`` callable
    — e.g. the port's SHA-256 kernel — overrides it)."""
    msgs = [salt + pt for pt in plaintexts]
    return (sha_many or sha256_many)(msgs)


def encrypt_chunks(plaintexts: list, salt: bytes, *, keys: list | None = None,
                   encrypt_many=None, sha_many=None) -> list:
    """Batched convergent encryption of N chunks — the FORWARD direction
    of ``decrypt_chunks``, through the same vectorized kernels: one
    batched SHA pass derives the keys (skipped when `keys` carries
    pre-derived ones from the publish pipeline), one batched AES-CTR
    block pass produces every keystream (``aes.ctr_keystream_many``;
    ``encrypt_many`` plugs in the port's AES kernel), and one more
    batched SHA pass names
    the ciphertexts. Returns ``EncryptedChunk`` per input, byte-for-byte
    identical to the serial ``encrypt_chunk`` oracle."""
    pts = list(plaintexts)
    if not pts:
        return []
    if keys is None:
        keys = derive_keys(pts, salt, sha_many=sha_many)
    ks = aes.ctr_keystream_many(list(keys), [len(p) for p in pts],
                                encrypt_many=encrypt_many)
    cts = [(np.frombuffer(p, np.uint8) ^ k).tobytes()
           for p, k in zip(pts, ks)]
    digests = (sha_many or sha256_many)(cts)
    return [EncryptedChunk(name=d.hex(), ciphertext=ct, key=k, sha256=d)
            for ct, k, d in zip(cts, keys, digests)]


def decrypt_chunk(ciphertext: bytes, key: bytes, expect_sha256: bytes) -> bytes:
    """Verify-then-decrypt; workers reject modified ciphertexts (§3.1).

    One chunk at a time — the serial reference path and the oracle for
    ``decrypt_chunks``."""
    if hashlib.sha256(ciphertext).digest() != expect_sha256:
        raise IntegrityError("chunk ciphertext hash mismatch")
    return aes.ctr_decrypt(ciphertext, key)


def decrypt_chunks(ciphertexts: list, keys: list, expect_sha256s: list, *,
                   encrypt_many=None, sha_many=None, fused=None) -> list:
    """Batched verify-then-decrypt of N chunks.

    Verification is one batched SHA pass over all ciphertexts
    (``sha256v.sha256_many``, or the ``sha_many`` hook — the port's
    SHA-256 kernel), decryption is one batched block pass
    (``aes.ctr_keystream_many``; ``encrypt_many`` plugs in the port's
    AES kernel; the decode-backend registry in ``core.decode`` pairs the
    two hooks).

    A ``fused`` callable (``repro_torch.kernels.fused.
    fused_verify_decrypt``) replaces BOTH passes with one: (ciphertexts, keys) -> (digests,
    plaintexts) from a single tiled walk over the bytes. The integrity
    contract is preserved — digests are compared before any plaintext
    leaves this function, and a tampered chunk raises the same
    ``IntegrityError`` naming every offending batch position — though
    the fused pass relaxes the internal ordering from "verify the whole
    batch, then decrypt" to "verify and decrypt together, release
    nothing on mismatch" (no bad chunk's plaintext is ever returned
    either way)."""
    if fused is not None:
        digests, plains = fused(list(ciphertexts), list(keys))
        bad = [i for i, (got, want)
               in enumerate(zip(digests, expect_sha256s)) if got != want]
        if bad:
            raise IntegrityError(
                f"chunk ciphertext hash mismatch at batch positions {bad}",
                bad)
        return plains
    digests = (sha_many or sha256_many)(list(ciphertexts))
    bad = [i for i, (got, want) in enumerate(zip(digests, expect_sha256s))
           if got != want]
    if bad:
        raise IntegrityError(
            f"chunk ciphertext hash mismatch at batch positions {bad}",
            bad)
    return aes.ctr_decrypt_many(list(ciphertexts), list(keys),
                                encrypt_many=encrypt_many)


class IntegrityError(Exception):
    """args[1], when present, lists the offending chunks: batch
    positions when raised by ``decrypt_chunks``, chunk names when
    raised by ``core.decode.BatchDecoder`` (which aggregates across
    tiles)."""

    @property
    def bad_positions(self) -> list:
        return list(self.args[1]) if len(self.args) > 1 else []


def make_salt(epoch: int, root_id: str, placement: str = "") -> bytes:
    """Deduplication salt: rotates with epoch (time / popularity policy),
    incorporates the active GC root (§3.4) and optionally the placement
    domain (AZ / datacenter)."""
    return hashlib.sha256(
        b"repro-salt|%d|%s|%s" % (epoch, root_id.encode(), placement.encode())
    ).digest()[:16]
