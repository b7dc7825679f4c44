"""Erasure coding for the L2 cache (paper §4.1; a copy of
``repro.core.erasure``: the port keeps its own so it never imports the
JAX package).

Systematic Reed–Solomon over GF(256), reduction polynomial 0x11D, with a
Vandermonde-derived encode matrix: k data stripes + (n-k) parity
stripes; any k of n reconstruct. The production 4-of-5 code's single
parity row is all ones, so encode is a k-way XOR: the ``parity_fn`` hook
(``kernels.parity.ops.parity_fn_for_erasure``) takes that over. The
batched ``decode_many`` sends each erasure signature's reconstruction
through the ``matmul_fn`` hook (``kernels.gf256.ops.rs_matmul_fn``).
Both hooks take and return numpy, so the coder behaves exactly as the
reference; numpy here is the oracle.
"""
from __future__ import annotations

import numpy as np

# --------------------------------------------------- GF(256) tables (0x11d)

_EXP = np.zeros(512, dtype=np.uint8)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def gf_mul(a, b):
    """Elementwise GF(256) multiply of uint8 arrays (log/exp tables)."""
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    out = _EXP[(_LOG[a].astype(np.int32) + _LOG[b].astype(np.int32)) % 255]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError
    return int(_EXP[255 - _LOG[a]])


def gf_matmul(m: np.ndarray, data: np.ndarray) -> np.ndarray:
    """(r,k) GF matrix x (k,L) stripes -> (r,L)."""
    r, k = m.shape
    out = np.zeros((r, data.shape[1]), dtype=np.uint8)
    for i in range(r):
        acc = np.zeros(data.shape[1], dtype=np.uint8)
        for j in range(k):
            c = int(m[i, j])
            if c == 0:
                continue
            if c == 1:
                acc ^= data[j]
            else:
                acc ^= _EXP[(_LOG[data[j]].astype(np.int32) + _LOG[c]) % 255] \
                    * (data[j] != 0)
        out[i] = acc
    return out


def _gf_matinv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a small GF(256) matrix."""
    k = m.shape[0]
    a = m.astype(np.uint8).copy()
    inv = np.eye(k, dtype=np.uint8)
    for col in range(k):
        piv = next((r for r in range(col, k) if a[r, col]), None)
        if piv is None:
            raise ValueError("singular matrix")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        pinv = gf_inv(int(a[col, col]))
        a[col] = gf_mul(a[col], pinv)
        inv[col] = gf_mul(inv[col], pinv)
        for r in range(k):
            if r != col and a[r, col]:
                f = int(a[r, col])
                a[r] ^= gf_mul(a[col], f)
                inv[r] ^= gf_mul(inv[col], f)
    return inv


def encode_matrix(k: int, n: int) -> np.ndarray:
    """Systematic: top k rows identity; parity rows from Vandermonde
    eliminated to keep the systematic property (any k rows invertible).

    For n-k == 1 the single parity row is forced to all-ones so encode
    (pure XOR) and decode agree; [I; 1...1] is MDS for one parity."""
    if n - k == 1:
        full = np.zeros((n, k), dtype=np.uint8)
        full[:k] = np.eye(k, dtype=np.uint8)
        full[k] = 1
        return full
    v = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        for j in range(k):
            v[i, j] = _EXP[(i * j) % 255]
    top_inv = _gf_matinv(v[:k])
    full = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        for j in range(k):
            acc = 0
            for t in range(k):
                acc ^= int(gf_mul(v[i, t], top_inv[t, j]))
            full[i, j] = acc
    return full


class ErasureCoder:
    def __init__(self, k: int = 4, n: int = 5, parity_fn=None,
                 matmul_fn=None):
        assert 1 <= k < n <= 255
        self.k, self.n = k, n
        self.matrix = encode_matrix(k, n)
        # parity_fn((k, L) uint8) -> (L,) uint8: the n-k == 1 XOR row
        self.parity_fn = parity_fn
        # matmul_fn(matrix, (k, L) uint8) -> (r, L) uint8: the GF matmul
        # of the batched ``decode_many`` reconstruction
        self.matmul_fn = matmul_fn

    def stripe_len(self, chunk_len: int) -> int:
        return (chunk_len + self.k - 1) // self.k

    def encode(self, chunk: bytes) -> list:
        """chunk -> n stripes (each stripe_len bytes; data zero-padded)."""
        L = self.stripe_len(len(chunk))
        buf = np.zeros(self.k * L, dtype=np.uint8)
        buf[:len(chunk)] = np.frombuffer(chunk, np.uint8)
        data = buf.reshape(self.k, L)
        if self.n - self.k == 1:
            if self.parity_fn is not None:
                parity = np.asarray(self.parity_fn(data)).reshape(1, L)
            else:
                parity = data[0].copy()
                for j in range(1, self.k):
                    parity = parity ^ data[j]
                parity = parity.reshape(1, L)
        else:
            parity = gf_matmul(self.matrix[self.k:], data)
        stripes = np.concatenate([data, parity], axis=0)
        return [stripes[i].tobytes() for i in range(self.n)]

    def decode(self, stripes: dict, chunk_len: int) -> bytes:
        """stripes: {index -> bytes}, any k entries; returns the chunk."""
        if len(stripes) < self.k:
            raise ValueError(f"need {self.k} stripes, got {len(stripes)}")
        idx = sorted(stripes)[: self.k]
        if idx == list(range(self.k)):
            data = np.stack([np.frombuffer(stripes[i], np.uint8) for i in idx])
        else:
            inv = _gf_matinv(self.matrix[idx])
            got = np.stack([np.frombuffer(stripes[i], np.uint8) for i in idx])
            data = gf_matmul(inv, got)
        return data.reshape(-1)[:chunk_len].tobytes()

    def decode_many(self, stripes_list: list, chunk_lens: list) -> list:
        """Batched decode: one GF matmul per distinct (surviving-stripe
        signature, stripe length) group, the group's stripes
        concatenated along the length axis. The all-data signature needs
        no math. Byte-identical to calling ``decode`` per chunk."""
        groups: dict[tuple, list[int]] = {}
        for pos, (stripes, clen) in enumerate(zip(stripes_list, chunk_lens)):
            if len(stripes) < self.k:
                raise ValueError(
                    f"need {self.k} stripes, got {len(stripes)} "
                    f"(batch position {pos})")
            idx = tuple(sorted(stripes)[: self.k])
            groups.setdefault((idx, self.stripe_len(clen)), []).append(pos)
        out: list[bytes | None] = [None] * len(stripes_list)
        ident = tuple(range(self.k))
        for (idx, L), members in groups.items():
            if idx == ident:
                for pos in members:
                    s = stripes_list[pos]
                    out[pos] = b"".join(s[i] for i in idx)[:chunk_lens[pos]]
                continue
            # (k, len(members)*L): one matmul reconstructs the whole group
            got = np.stack([
                np.frombuffer(b"".join(stripes_list[pos][i]
                                       for pos in members), np.uint8)
                for i in idx])
            inv = _gf_matinv(self.matrix[list(idx)])
            mm = self.matmul_fn if self.matmul_fn is not None else gf_matmul
            data = np.asarray(mm(inv, got), np.uint8)
            for j, pos in enumerate(members):
                chunk = data[:, j * L:(j + 1) * L]
                out[pos] = chunk.reshape(-1)[:chunk_lens[pos]].tobytes()
        return out
