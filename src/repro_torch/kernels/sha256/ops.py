"""SHA-256 over N messages: the CUDA kernel (``csrc/sha256.cu``) and its
plain PyTorch version, behind one tensor contract and one host hook.

Tensor contract (``sha256_lanes``): ``buf`` uint8 (M,) holds the
messages back to back, ``offsets``/``lengths`` int64 (N,) locate them;
returns uint8 (N, 32) big-endian digests. A CUDA ``buf`` launches the
kernel; a CPU ``buf`` runs the plain version. There is no fallback
between the two.

Host hook (``sha256_many``): list of byte strings -> list of 32-byte
digests, byte-identical to hashlib. It is the ``sha_many`` hook of the
``torch`` and ``torch-fused`` decode backends (``core.decode``), used
for chunk naming and convergent key derivation on publish and for the
two-pass verify.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.crypto.sha256v import _H0, _K

M32 = 0xFFFFFFFF
ALIGN = 16          # message offsets in a packed buffer (16-byte loads)
GEOMETRY_KEYS = ("group", "stages", "warps", "threads", "smem_bytes",
                 "blocks")
# one CUDA-graph capture at a time: PyTorch captures on a side stream
# that all threads share
_CAPTURE_LOCK = threading.Lock()


def pack_messages(datas: list) -> tuple:
    """(buf uint8, offsets int64, lengths int64) numpy arrays: the
    messages back to back, each starting at a multiple of ``ALIGN``."""
    lengths = np.fromiter((len(d) for d in datas), np.int64, len(datas))
    spans = (lengths + ALIGN - 1) // ALIGN * ALIGN
    offsets = np.zeros(len(datas), np.int64)
    if len(datas) > 1:
        np.cumsum(spans[:-1], out=offsets[1:])
    buf = np.empty(max(1, int(spans.sum())), np.uint8)
    for d, o, n in zip(datas, offsets, lengths):
        buf[o:o + n] = np.frombuffer(d, np.uint8)
    return buf, offsets, lengths


def to_device(buf: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
              device) -> tuple:
    return (torch.from_numpy(buf).to(device),
            torch.from_numpy(offsets).to(device),
            torch.from_numpy(lengths).to(device))


# ------------------------------------------------------ plain version

def _words_be(b: torch.Tensor) -> torch.Tensor:
    """(..., 4k) bytes -> (..., k) int64 big-endian words."""
    b = b.to(torch.int64).reshape(*b.shape[:-1], -1, 4)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """(..., k) int64 words in [0, 2^32) -> (..., 4k) uint8 big-endian."""
    shifts = torch.tensor([24, 16, 8, 0], device=w.device)
    b = (w[..., None] >> shifts) & 0xFF
    return b.reshape(*w.shape[:-1], -1).to(torch.uint8)


def padded_words(buf: torch.Tensor, offsets: torch.Tensor,
                 lengths: torch.Tensor) -> tuple:
    """Padded message schedules (sha256v._pad) of every lane:
    ((N, maxb, 16) int64 big-endian words, (N,) block counts)."""
    dev = buf.device
    nblocks = (lengths + 72) // 64
    maxb = int(nblocks.max())
    p = torch.arange(maxb * 64, device=dev)
    idx = (offsets[:, None] + p).clamp_(max=buf.numel() - 1)
    data = buf[idx]
    inside = p < lengths[:, None]
    pad = torch.where(p == lengths[:, None], 0x80, 0).to(torch.uint8)
    byte = torch.where(inside, data, pad)
    k = p - ((nblocks - 1) * 64 + 56)[:, None]          # length field
    in_len = (k >= 0) & (k < 8)
    lbyte = ((lengths * 8)[:, None] >> (8 * (7 - k.clamp(0, 7)))) & 0xFF
    byte = torch.where(in_len, lbyte.to(torch.uint8), byte)
    return _words_be(byte.reshape(-1, maxb, 64)), nblocks


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & M32


def sha256_words_plain(words: torch.Tensor,
                       nblocks: torch.Tensor) -> torch.Tensor:
    """Lockstep SHA-256 of (N, maxb, 16) schedule words: lanes freeze
    after their last block (sha256v.sha256_many_np). The message
    schedule is expanded for every block at once; the 64 rounds run per
    block, vectorised over lanes. On a CUDA device that per-block step
    is replayed as a CUDA graph (``_graphed``). Returns (N, 8) int64
    state words."""
    n, maxb, _ = words.shape
    dev = words.device
    w = torch.empty((n, maxb, 64), dtype=torch.int64, device=dev)
    w[..., :16] = words
    for t in range(16, 64):
        x15, x2 = w[..., t - 15], w[..., t - 2]
        s0 = _rotr(x15, 7) ^ _rotr(x15, 18) ^ (x15 >> 3)
        s1 = _rotr(x2, 17) ^ _rotr(x2, 19) ^ (x2 >> 10)
        w[..., t] = (w[..., t - 16] + s0 + w[..., t - 7] + s1) & M32
    k = torch.from_numpy(_K.astype(np.int64)).to(dev)
    kw = ((w + k) & M32).permute(1, 2, 0).contiguous()   # (maxb, 64, N)
    del w
    state = torch.from_numpy(_H0.astype(np.int64)).to(dev)[:, None] \
        .repeat(1, n)                                     # (8, N)
    kb = torch.empty_like(kw[0])
    blk = torch.zeros((), dtype=torch.int64, device=dev)
    step = _graphed(_fold_block, state, kb, blk, nblocks) \
        if dev.type == "cuda" else \
        (lambda: _fold_block(state, kb, blk, nblocks))
    for b in range(maxb):
        kb.copy_(kw[b])
        blk.fill_(b)
        step()
    return state.T


def _fold_block(state: torch.Tensor, kb: torch.Tensor, blk: torch.Tensor,
                nblocks: torch.Tensor) -> None:
    """One block's 64 rounds on (8, N) `state` with (64, N) K+W words
    `kb`, in place; lanes whose last block is before `blk` keep their
    state."""
    a, b, c, d, e, f, g, h = state.unbind(0)
    for t in range(64):
        # a value v < 2^32 doubled into both halves of an int64 rotates
        # right by n as (vv >> n) & M32
        ee = e | (e << 32)
        s1 = ((ee >> 6) ^ (ee >> 11) ^ (ee >> 25)) & M32
        t1 = h + s1 + (g ^ (e & (f ^ g))) + kb[t]
        aa = a | (a << 32)
        s0 = ((aa >> 2) ^ (aa >> 13) ^ (aa >> 22)) & M32
        maj = (a & b) | (c & (a | b))
        h, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & M32
    new = (state + torch.stack((a, b, c, d, e, f, g, h))) & M32
    state.copy_(torch.where(nblocks > blk, new, state))


def _graphed(fn, *args):
    """`fn(*args)` captured once as a CUDA graph and returned as a
    replay: the same PyTorch ops on the same tensors, launched without
    the per-op cost that otherwise dominates thousands of tiny steps.
    The warm-up run's effect on `args[0]` is undone before capture.
    The capture runs in ``thread_local`` mode, so what other threads do
    meanwhile (kernel launches, copies, allocations on their own
    streams) neither fails nor invalidates it, and holds
    ``_CAPTURE_LOCK``."""
    saved = args[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _CAPTURE_LOCK, torch.cuda.graph(graph,
                                         capture_error_mode="thread_local"):
        fn(*args)
    args[0].copy_(saved)
    return graph.replay


def sha256_lanes_plain(buf: torch.Tensor, offsets: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same contract."""
    if offsets.numel() == 0:
        return torch.empty((0, 32), dtype=torch.uint8, device=buf.device)
    words, nblocks = padded_words(buf, offsets, lengths)
    return words_to_bytes(sha256_words_plain(words, nblocks))


# ------------------------------------------------------------ wrapper

def sha256_lanes(buf: torch.Tensor, offsets: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Digests of the N messages in `buf` (module doc): the CUDA kernel
    for a CUDA `buf`, the plain version for a CPU one."""
    dev = buf.device
    kernels.check_tensor(buf, "buf", torch.uint8, dev, 1)
    kernels.check_tensor(offsets, "offsets", torch.int64, dev, 1)
    kernels.check_tensor(lengths, "lengths", torch.int64, dev, 1)
    if offsets.shape != lengths.shape:
        raise ValueError("offsets and lengths differ in shape")
    if dev.type == "cpu":
        return sha256_lanes_plain(buf, offsets, lengths)
    if dev.type != "cuda":
        raise ValueError(f"sha256_lanes runs on cuda or cpu, not {dev}")
    n = offsets.numel()
    out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    if n:
        kernels.launch("sha256", "sha256_many", buf.data_ptr(),
                       offsets.data_ptr(), lengths.data_ptr(), n,
                       out.data_ptr())
    return out


def geometry(n: int) -> dict:
    """The kernel's launch geometry for `n` messages (GEOMETRY_KEYS),
    as ``csrc/sha256.cu`` computes it."""
    return kernels.geometry("sha256", "sha256_lanes_geometry", n,
                            GEOMETRY_KEYS)


def sha256_many(datas: list, *, device="cuda") -> list:
    """``sha_many`` hook: digests of N byte strings on `device`."""
    if not datas:
        return []
    dig = sha256_lanes(*to_device(*pack_messages(datas), device))
    raw = dig.cpu().numpy()
    return [raw[i].tobytes() for i in range(len(datas))]
