"""The card's peaks and the least time of verify+decrypt work: a frozen
copy of ``chip_smoke.py``'s ``bound``/``sha_blocks`` arithmetic, kept with
the benchmark so that a change to the program cannot move the yardstick.

Peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W): HBM 3.35 TB/s;
the 32-bit integer rate 16.7 Tops/s (132 SMs x 64 INT32 lanes x 1.98
GHz). Operations are the fewest 32-bit instructions the algorithms need,
so each bound is a least time:

* SHA-256 per 64-byte block: 16 byte swaps, the schedule 48 x 10, the
  rounds 64 x 14, the final 8 adds (1400);
* AES-256 per 16-byte block (T-table): the initial key xor 4, 13 middle
  rounds x 24, the final round 32 (348).

The work is counted from the bytes a cell decodes, never from launches
or tiles, so it reads the same whatever kernel design carries it: per
chunk of n bytes, ``sha_blocks([n])`` SHA-256 blocks and n / 16 AES
blocks, and each byte read once and written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SHA_OPS_PER_BLOCK = 16 + 48 * 10 + 64 * 14 + 8
AES_OPS_PER_BLOCK = 4 + 13 * 24 + 32


def sha_blocks(lengths) -> int:
    """SHA-256 compression blocks of messages of these byte lengths
    (the message, the 0x80 byte and the 8-byte length, padded to 64)."""
    return sum((int(n) + 72) // 64 for n in lengths)


def decode_work(chunks: int, chunk_bytes: int) -> tuple:
    """(operations, bytes) of verifying and decrypting `chunks` chunks of
    `chunk_bytes`: the ciphertext read once, the plaintext written once,
    the 32-byte digest written once."""
    ops = chunks * (sha_blocks([chunk_bytes]) * SHA_OPS_PER_BLOCK
                    + -(-chunk_bytes // 16) * AES_OPS_PER_BLOCK)
    nbytes = chunks * (2 * chunk_bytes + 32)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> tuple:
    """(least seconds, what sets it): the larger of the operations over
    the INT32 rate and the bytes over the HBM rate."""
    terms = {"operations": ops / INT32_OPS_PER_S,
             "bytes": nbytes / HBM_BYTES_PER_S}
    by = max(terms, key=terms.get)
    return terms[by], by
