"""SHA-256 constants, padding and the batched host digests (the copy of
``repro.core.crypto.sha256v``). ``_K``, ``_H0`` and ``_pad`` are the
reference the port's SHA-256 kernel and its plain PyTorch version follow
(``kernels/sha256``); ``sha256_many`` is the hashlib pass that
``convergent`` uses when no ``sha_many`` hook is given.
``sha256_many_np`` (``sha256_many(..., backend="numpy")``) advances all
N messages' compression functions in lockstep as (N,) uint32 lanes, a
message's lane frozen once its last padded block is absorbed: the
shape of the lockstep kernel, kept as a numpy oracle.
"""
from __future__ import annotations

import hashlib

import numpy as np

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2], dtype=np.uint32)

_H0 = np.array([0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19],
               dtype=np.uint32)


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _pad(msg: bytes) -> bytes:
    bitlen = len(msg) * 8
    pad = b"\x80" + b"\x00" * ((55 - len(msg)) % 64)
    return msg + pad + bitlen.to_bytes(8, "big")


def sha256_many_np(datas: list) -> list:
    """Vectorized digests of N byte strings; lockstep lanes, masked tail."""
    n = len(datas)
    if n == 0:
        return []
    padded = [_pad(d) for d in datas]
    nblocks = np.array([len(p) // 64 for p in padded])
    maxb = int(nblocks.max())
    # (N, maxb, 16) big-endian words, zero blocks past each message's end
    words = np.zeros((n, maxb, 16), dtype=np.uint32)
    for i, p in enumerate(padded):
        w = np.frombuffer(p, dtype=">u4").reshape(-1, 16)
        words[i, :w.shape[0]] = w
    state = np.repeat(_H0[None, :], n, axis=0).copy()     # (N, 8)
    with np.errstate(over="ignore"):
        for b in range(maxb):
            w = np.zeros((n, 64), dtype=np.uint32)
            w[:, :16] = words[:, b]
            for t in range(16, 64):
                s0 = _rotr(w[:, t - 15], 7) ^ _rotr(w[:, t - 15], 18) \
                    ^ (w[:, t - 15] >> np.uint32(3))
                s1 = _rotr(w[:, t - 2], 17) ^ _rotr(w[:, t - 2], 19) \
                    ^ (w[:, t - 2] >> np.uint32(10))
                w[:, t] = w[:, t - 16] + s0 + w[:, t - 7] + s1
            a, bb, c, d, e, f, g, h = (state[:, j].copy() for j in range(8))
            for t in range(64):
                s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
                ch = (e & f) ^ (~e & g)
                t1 = h + s1 + ch + _K[t] + w[:, t]
                s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
                maj = (a & bb) ^ (a & c) ^ (bb & c)
                t2 = s0 + maj
                h, g, f, e, d, c, bb, a = g, f, e, d + t1, c, bb, a, t1 + t2
            new = state + np.stack([a, bb, c, d, e, f, g, h], axis=1)
            active = (nblocks > b)[:, None]
            state = np.where(active, new, state)
    be = state.astype(">u4")
    return [be[i].tobytes() for i in range(n)]


def sha256_many(datas: list, backend: str = "hashlib") -> list:
    """Digests of N byte strings: hashlib, one C call each (it releases
    the GIL), or the numpy lockstep lanes with ``backend="numpy"``."""
    if backend == "numpy":
        return sha256_many_np(datas)
    return [hashlib.sha256(d).digest() for d in datas]
