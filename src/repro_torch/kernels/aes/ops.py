"""AES block encryption with per-chunk round keys: the CUDA kernel
(``csrc/aes.cu``) and its plain PyTorch version, behind one tensor
contract and one host hook.

Tensor contract (``aes_encrypt_blocks``): ``blocks`` uint8 (N, 16),
``rks`` int32 (C, R+1, 4) holding the uint32 big-endian round-key words
of ``aes.expand_key`` bit for bit, ``chunk_idx`` int32 (N,) naming each
block's schedule; returns uint8 (N, 16). A CUDA ``blocks`` launches the
kernel; a CPU one runs the plain version.

Host hook (``encrypt_many``): the ``encrypt_many`` contract of
``aes.ctr_keystream_many`` with ``per_chunk_rks``: (N, 16) uint8
blocks, (C, R+1, 4) uint32 schedules and ``counts`` (blocks per
schedule) -> (N, 16) uint8, byte-identical to ``aes.encrypt_blocks``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.crypto import aes

M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple:
    """(T (4, 256), S-box (256,)) as int64 tensors on `device`."""
    t = np.stack([aes._T0, aes._T1, aes._T2, aes._T3]).astype(np.int64)
    return (torch.from_numpy(t).to(device),
            torch.from_numpy(aes._SBOX.astype(np.int64)).to(device))


def _bytes_to_cols(b: torch.Tensor) -> torch.Tensor:
    b = b.to(torch.int64).reshape(-1, 4, 4)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def _cols_to_bytes(c: torch.Tensor) -> torch.Tensor:
    shifts = torch.tensor([24, 16, 8, 0], device=c.device)
    return ((c[..., None] >> shifts) & 0xFF).reshape(-1, 16).to(torch.uint8)


def encrypt_cols_plain(cols: torch.Tensor, rk: torch.Tensor,
                       chunk_idx: torch.Tensor) -> torch.Tensor:
    """T-table AES over (N, 4) int64 big-endian columns
    (aes.encrypt_blocks): ``rk`` (C, R+1, 4) int64 schedules, one per
    chunk, ``chunk_idx`` (N,) picks each block's. Vectorised over
    blocks, one step per round."""
    t, sbox = _tables(cols.device)
    idx = chunk_idx.long()
    rounds = rk.shape[1] - 1
    cols = cols ^ rk[idx, 0]
    for r in range(1, rounds + 1):
        b = [(cols >> s) & 0xFF for s in (24, 16, 8, 0)]
        # byte i of column j+i feeds column j (ShiftRows)
        b = [torch.roll(x, -i, dims=1) for i, x in enumerate(b)]
        if r < rounds:
            cols = t[0][b[0]] ^ t[1][b[1]] ^ t[2][b[2]] ^ t[3][b[3]]
        else:
            cols = (sbox[b[0]] << 24) | (sbox[b[1]] << 16) \
                | (sbox[b[2]] << 8) | sbox[b[3]]
        cols = cols ^ rk[idx, r]
    return cols


def aes_encrypt_blocks_plain(blocks: torch.Tensor, rks: torch.Tensor,
                             chunk_idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same contract."""
    if blocks.shape[0] == 0:
        return torch.empty((0, 16), dtype=torch.uint8, device=blocks.device)
    rk = rks.to(torch.int64) & M32
    return _cols_to_bytes(encrypt_cols_plain(_bytes_to_cols(blocks), rk,
                                             chunk_idx))


def aes_encrypt_blocks(blocks: torch.Tensor, rks: torch.Tensor,
                       chunk_idx: torch.Tensor) -> torch.Tensor:
    """Encrypt N blocks (module doc): the CUDA kernel for a CUDA
    `blocks`, the plain version for a CPU one."""
    dev = blocks.device
    kernels.check_tensor(blocks, "blocks", torch.uint8, dev, 2)
    kernels.check_tensor(rks, "rks", torch.int32, dev, 3)
    kernels.check_tensor(chunk_idx, "chunk_idx", torch.int32, dev, 1)
    if blocks.shape[1] != 16 or rks.shape[2] != 4 \
            or rks.shape[1] not in (11, 15):
        raise ValueError("blocks must be (N, 16) and rks (C, 11|15, 4)")
    if chunk_idx.shape[0] != blocks.shape[0]:
        raise ValueError("one chunk index per block")
    if dev.type == "cpu":
        return aes_encrypt_blocks_plain(blocks, rks, chunk_idx)
    if dev.type != "cuda":
        raise ValueError(f"aes_encrypt_blocks runs on cuda or cpu, not {dev}")
    # the kernel moves blocks and round keys as 16-byte words
    if blocks.data_ptr() % 16:
        blocks = blocks.clone()
    if rks.data_ptr() % 16:
        rks = rks.clone()
    n = blocks.shape[0]
    out = torch.empty((n, 16), dtype=torch.uint8, device=dev)
    if n:
        kernels.launch("aes", "aes_encrypt_many", blocks.data_ptr(),
                       chunk_idx.data_ptr(), rks.data_ptr(),
                       rks.shape[1] - 1, n, out.data_ptr())
    return out


GEOMETRY_KEYS = ("threads", "blocks_per_thread", "key_slots", "smem_bytes",
                 "blocks_per_sm", "sms", "grid")


def geometry(n: int) -> dict:
    """The kernel's launch geometry for `n` blocks (GEOMETRY_KEYS), as
    ``csrc/aes.cu`` computes it on the current card."""
    return kernels.geometry("aes", "aes_geometry", n, GEOMETRY_KEYS)


def encrypt_many(blocks_u8: np.ndarray, rks: np.ndarray, *,
                 counts: np.ndarray | None = None,
                 device="cuda") -> np.ndarray:
    """``encrypt_many`` hook (module doc) on `device`. ``rks`` is (C,
    R+1, 4) with ``counts`` (run-length, ``per_chunk_rks``), else
    (N, R+1, 4) per block or (R+1, 4) shared."""
    n = blocks_u8.shape[0]
    if n == 0:
        return np.empty((0, 16), np.uint8)
    rks = np.asarray(rks, np.uint32)
    if counts is None:
        if rks.ndim == 2:
            rks, counts = rks[None], np.array([n], np.int64)
        else:
            counts = np.ones(n, np.int64)
    idx = np.repeat(np.arange(len(counts), dtype=np.int32),
                    np.asarray(counts, np.int64))
    if idx.shape[0] != n:
        raise ValueError(f"counts cover {idx.shape[0]} blocks, not {n}")
    out = aes_encrypt_blocks(
        torch.from_numpy(np.ascontiguousarray(blocks_u8)).to(device),
        torch.from_numpy(np.ascontiguousarray(rks).view(np.int32)).to(device),
        torch.from_numpy(idx).to(device))
    return out.cpu().numpy()


encrypt_many.per_chunk_rks = True
