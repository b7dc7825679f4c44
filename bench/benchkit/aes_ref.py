"""Plain AES-256 (FIPS-197) in numpy: the benchmark's own cipher, written
from the standard and sharing no code with the program under test.

Used by the reference to check the write path's ciphertexts (AES-256 in
counter mode, zero IV, 128-bit big-endian block counter) and to open a
manifest's key table (the counter part of AES-GCM). Vectorised over
blocks; slow next to the card, so the reference runs it on a sample.
"""
from __future__ import annotations

import numpy as np


def _gmul(a: int, b: int) -> int:
    """Product in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1."""
    p = 0
    for _ in range(8):
        if b & 1:
            p ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return p


def _sbox() -> np.ndarray:
    """The S-box: multiplicative inverse, then the affine map (5.1.1)."""
    inv = [0] * 256
    for x in range(1, 256):
        for y in range(1, 256):
            if _gmul(x, y) == 1:
                inv[x] = y
                break
    out = np.zeros(256, np.uint8)
    for x in range(256):
        b = inv[x]
        s = b
        for k in range(1, 5):
            s ^= ((b << k) | (b >> (8 - k))) & 0xFF
        out[x] = s ^ 0x63
    return out


SBOX = _sbox()
MUL2 = np.array([_gmul(x, 2) for x in range(256)], np.uint8)
MUL3 = np.array([_gmul(x, 3) for x in range(256)], np.uint8)
# state byte r + 4c; ShiftRows moves row r left by r columns
SHIFT = np.array([r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)])


def expand_key(key: bytes) -> np.ndarray:
    """The 15 round keys of a 32-byte key, (15, 16) uint8 (5.2)."""
    if len(key) != 32:
        raise ValueError("AES-256 takes a 32-byte key")
    w = [list(key[4 * i:4 * i + 4]) for i in range(8)]
    rcon = 1
    for i in range(8, 60):
        t = list(w[i - 1])
        if i % 8 == 0:
            t = [int(SBOX[b]) for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = _gmul(rcon, 2)
        elif i % 8 == 4:
            t = [int(SBOX[b]) for b in t]
        w.append([a ^ b for a, b in zip(w[i - 8], t)])
    return np.array(w, np.uint8).reshape(15, 16)


def encrypt_blocks(blocks: np.ndarray, round_keys: np.ndarray) -> np.ndarray:
    """AES-256 of (N, 16) uint8 blocks under one key schedule."""
    s = blocks ^ round_keys[0]
    for rnd in range(1, 15):
        s = SBOX[s][:, SHIFT]
        if rnd < 14:
            a = s.reshape(-1, 4, 4)
            a0, a1, a2, a3 = a[:, :, 0], a[:, :, 1], a[:, :, 2], a[:, :, 3]
            m = np.empty_like(a)
            m[:, :, 0] = MUL2[a0] ^ MUL3[a1] ^ a2 ^ a3
            m[:, :, 1] = a0 ^ MUL2[a1] ^ MUL3[a2] ^ a3
            m[:, :, 2] = a0 ^ a1 ^ MUL2[a2] ^ MUL3[a3]
            m[:, :, 3] = MUL3[a0] ^ a1 ^ a2 ^ MUL2[a3]
            s = m.reshape(-1, 16)
        s = s ^ round_keys[rnd]
    return s


def _counters(prefix: bytes, first: int, n: int, width: int) -> np.ndarray:
    """n counter blocks: `prefix` then a big-endian counter of `width`
    bytes counting up from `first` (wrapping at 2^(8 width))."""
    vals = (first + np.arange(n, dtype=np.uint64)) \
        & np.uint64((1 << (8 * width)) - 1 if width < 8 else (1 << 64) - 1)
    out = np.zeros((n, 16), np.uint8)
    out[:, :16 - width] = np.frombuffer(prefix, np.uint8)
    be = vals.astype(">u8").view(np.uint8).reshape(n, 8)
    out[:, 16 - width:] = be[:, 8 - width:]
    return out


def ctr_xor(data: bytes, key: bytes) -> bytes:
    """AES-256-CTR with a zero IV: block m's counter is m as a 128-bit
    big-endian integer (under 2^64 blocks here, so the top half is 0)."""
    n = len(data)
    blocks = (n + 15) // 16
    ks = encrypt_blocks(_counters(b"\x00" * 8, 0, blocks, 8),
                        expand_key(key)).reshape(-1)[:n]
    return (np.frombuffer(data, np.uint8) ^ ks).tobytes()


def gcm_ctr_xor(data: bytes, key: bytes, nonce: bytes) -> bytes:
    """The counter-mode part of AES-GCM (SP 800-38D, 12-byte nonce):
    the keystream starts at inc32(J0), J0 = nonce || 0x00000001. The tag
    is not checked here."""
    if len(nonce) != 12:
        raise ValueError("GCM takes a 12-byte nonce here")
    n = len(data)
    blocks = (n + 15) // 16
    ks = encrypt_blocks(_counters(nonce, 2, blocks, 4),
                        expand_key(key)).reshape(-1)[:n]
    return (np.frombuffer(data, np.uint8) ^ ks).tobytes()
