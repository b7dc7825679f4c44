"""Fused verify+decrypt: the CUDA kernel (``csrc/fused.cu``) and its
plain PyTorch version, behind one tensor contract and one host hook.

Tensor contract (``fused_verify_decrypt_lanes``): ciphertexts packed as
in ``sha256.ops`` (``buf`` uint8, ``offsets``/``lengths`` int64 (N,)),
``rks`` int32 (N, R+1, 4) per-chunk round keys; returns (plaintext
uint8 laid out like ``buf``, digests uint8 (N, 32)). Plaintext bytes
past each chunk's length are undefined. A CUDA ``buf`` launches the
kernel; a CPU one runs the plain version.

Host hook (``fused_verify_decrypt``): (ciphertexts, 32-byte keys) ->
(digests, plaintexts), digests byte-identical to hashlib, plaintexts
to AES-256-CTR with a zero IV. It is the ``fused`` hook of the
``torch-fused`` decode backend; ``convergent.decrypt_chunks`` compares
the digests before it releases any plaintext, so a tampered chunk
still raises ``IntegrityError`` naming it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.crypto.aes import expand_key
from repro_torch.kernels.aes.ops import M32, _cols_to_bytes, \
    encrypt_cols_plain
from repro_torch.kernels.sha256.ops import pack_messages, \
    sha256_lanes_plain, to_device

GEOMETRY_KEYS = ("group", "stages", "hash_warps", "threads", "smem_bytes",
                 "hash_blocks", "ctr_blocks")


def ctr_decrypt_plain(buf: torch.Tensor, offsets: torch.Tensor,
                      lengths: torch.Tensor,
                      rks: torch.Tensor) -> torch.Tensor:
    """AES-CTR (zero IV, 128-bit big-endian block counter) of every
    chunk XORed into a copy of `buf`, vectorised over all blocks."""
    dev = buf.device
    out = buf.clone()
    nb = (lengths + 15) // 16
    total = int(nb.sum())
    if total == 0:
        return out
    chunk = torch.repeat_interleave(torch.arange(len(nb), device=dev), nb)
    start = torch.cumsum(nb, 0) - nb
    m = torch.arange(total, device=dev) - start[chunk]
    cols = torch.zeros((total, 4), dtype=torch.int64, device=dev)
    cols[:, 2] = m >> 32
    cols[:, 3] = m & M32
    ks = _cols_to_bytes(encrypt_cols_plain(cols, rks.to(torch.int64) & M32,
                                           chunk))
    pos = (16 * m)[:, None] + torch.arange(16, device=dev)
    valid = pos < lengths[chunk][:, None]
    at = (offsets[chunk][:, None] + pos)[valid]
    out[at] = buf[at] ^ ks[valid]
    return out


def fused_lanes_plain(buf, offsets, lengths, rks) -> tuple:
    """The plain PyTorch version of the kernel: same contract."""
    return (ctr_decrypt_plain(buf, offsets, lengths, rks),
            sha256_lanes_plain(buf, offsets, lengths))


def fused_verify_decrypt_lanes(buf: torch.Tensor, offsets: torch.Tensor,
                               lengths: torch.Tensor,
                               rks: torch.Tensor) -> tuple:
    """(plaintext buffer, digests) of N chunks (module doc): the CUDA
    kernel for a CUDA `buf`, the plain version for a CPU one."""
    dev = buf.device
    kernels.check_tensor(buf, "buf", torch.uint8, dev, 1)
    kernels.check_tensor(offsets, "offsets", torch.int64, dev, 1)
    kernels.check_tensor(lengths, "lengths", torch.int64, dev, 1)
    kernels.check_tensor(rks, "rks", torch.int32, dev, 3)
    n = offsets.shape[0]
    if lengths.shape[0] != n or rks.shape[0] != n or rks.shape[2] != 4 \
            or rks.shape[1] not in (11, 15):
        raise ValueError("need N offsets, N lengths and (N, 11|15, 4) rks")
    if dev.type == "cpu":
        return fused_lanes_plain(buf, offsets, lengths, rks)
    if dev.type != "cuda":
        raise ValueError(f"fused_verify_decrypt runs on cuda or cpu, not {dev}")
    plain = torch.empty_like(buf)
    digests = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    if n:
        kernels.launch("fused", "fused_verify_decrypt", buf.data_ptr(),
                       offsets.data_ptr(), lengths.data_ptr(),
                       rks.data_ptr(), rks.shape[1] - 1, n,
                       plain.data_ptr(), digests.data_ptr())
    return plain, digests


def geometry(n: int) -> dict:
    """The kernel's launch geometry for `n` chunks (GEOMETRY_KEYS), as
    ``csrc/fused.cu`` computes it on the current card."""
    return kernels.geometry("fused", "fused_geometry", n, GEOMETRY_KEYS)


def round_keys(keys: list) -> np.ndarray:
    """(N, R+1, 4) uint32 schedules, each distinct key expanded once."""
    expanded: dict = {}
    return np.stack([expanded[k] if k in expanded
                     else expanded.setdefault(k, expand_key(k))
                     for k in keys])


def fused_verify_decrypt(cts: list, keys: list, *, device="cuda") -> tuple:
    """``fused`` hook (module doc) on `device`."""
    n = len(cts)
    if n == 0:
        return [], []
    buf, offsets, lengths = pack_messages(cts)
    rks = torch.from_numpy(round_keys(keys).view(np.int32)).to(device)
    plain, dig = fused_verify_decrypt_lanes(
        *to_device(buf, offsets, lengths, device), rks)
    plain = plain.cpu().numpy()
    dig = dig.cpu().numpy()
    return ([dig[i].tobytes() for i in range(n)],
            [plain[o:o + ln].tobytes() for o, ln in zip(offsets, lengths)])
