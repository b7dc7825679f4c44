"""AES-128/256 (encrypt direction), CTR and GCM modes — pure numpy.

The paper encrypts every chunk with AES-CTR under a convergent key and the
manifest key-table with AES-GCM under a per-customer key (§3.1). No crypto
libraries are available offline, so this is a vectorized T-table AES: the
whole chunk's counter blocks run through each round as one (N,4) uint32
array (the copy of ``repro.core.crypto.aes``, which is validated
against FIPS-197 / SP800-38A / GCM test vectors).

This implementation is NOT constant-time; it is a faithful functional model
of the paper's data path (keystream, naming, authentication), which is what
the system properties depend on.
"""
from __future__ import annotations

import numpy as np

# ------------------------------------------------------------ tables

_SBOX = np.array([
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16], dtype=np.uint8)


def _xtime(a: np.ndarray) -> np.ndarray:
    return (((a.astype(np.uint16) << 1) ^
             np.where(a & 0x80, 0x1B, 0)) & 0xFF).astype(np.uint8)


_S = _SBOX
_S2 = _xtime(_S)
_S3 = _S2 ^ _S
_U32 = lambda a, b, c, d: ((a.astype(np.uint32) << 24) | (b.astype(np.uint32) << 16)
                           | (c.astype(np.uint32) << 8) | d.astype(np.uint32))
_T0 = _U32(_S2, _S, _S, _S3)
_T1 = _U32(_S3, _S2, _S, _S)
_T2 = _U32(_S, _S3, _S2, _S)
_T3 = _U32(_S, _S, _S3, _S2)

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36,
         0x6C, 0xD8, 0xAB, 0x4D]


def expand_key(key: bytes) -> np.ndarray:
    """Round keys as (rounds+1, 4) uint32 (big-endian column words)."""
    nk = len(key) // 4
    assert nk in (4, 8), "AES-128 or AES-256 only"
    rounds = {4: 10, 8: 14}[nk]
    w = [int.from_bytes(key[4 * i:4 * i + 4], "big") for i in range(nk)]
    sbox = _SBOX

    def sub_word(x):
        return (int(sbox[(x >> 24) & 0xFF]) << 24 | int(sbox[(x >> 16) & 0xFF]) << 16
                | int(sbox[(x >> 8) & 0xFF]) << 8 | int(sbox[x & 0xFF]))

    def rot_word(x):
        return ((x << 8) | (x >> 24)) & 0xFFFFFFFF

    for i in range(nk, 4 * (rounds + 1)):
        t = w[i - 1]
        if i % nk == 0:
            t = sub_word(rot_word(t)) ^ (_RCON[i // nk - 1] << 24)
        elif nk == 8 and i % nk == 4:
            t = sub_word(t)
        w.append(w[i - nk] ^ t)
    return np.array(w, dtype=np.uint32).reshape(rounds + 1, 4)


_SBOX32 = _SBOX.astype(np.uint32)


def expand_keys_many(keys: list) -> np.ndarray:
    """Round-key schedules for N same-length keys at once:
    (N, rounds+1, 4) uint32. The recurrence is sequential in the word
    index but vectorizes across keys — ~52 numpy steps replace ~52·N
    python steps, the dominant fixed cost of a many-distinct-key CTR
    batch (every convergent chunk has its own key)."""
    n = len(keys)
    nk = len(keys[0]) // 4
    assert nk in (4, 8), "AES-128 or AES-256 only"
    rounds = {4: 10, 8: 14}[nk]
    nwords = 4 * (rounds + 1)
    kb = np.frombuffer(b"".join(keys), np.uint8).reshape(n, nk, 4)
    kb = kb.astype(np.uint32)
    w = np.zeros((n, nwords), np.uint32)
    w[:, :nk] = (kb[:, :, 0] << 24) | (kb[:, :, 1] << 16) \
        | (kb[:, :, 2] << 8) | kb[:, :, 3]
    s = _SBOX32

    def sub(x):
        return ((s[(x >> 24) & 0xFF] << 24) | (s[(x >> 16) & 0xFF] << 16)
                | (s[(x >> 8) & 0xFF] << 8) | s[x & 0xFF])

    for i in range(nk, nwords):
        t = w[:, i - 1]
        if i % nk == 0:
            t = sub((t << np.uint32(8)) | (t >> np.uint32(24))) \
                ^ np.uint32((_RCON[i // nk - 1] << 24) & 0xFFFFFFFF)
        elif nk == 8 and i % nk == 4:
            t = sub(t)
        w[:, i] = w[:, i - nk] ^ t
    return w.reshape(n, rounds + 1, 4)


def encrypt_blocks(blocks: np.ndarray, round_keys: np.ndarray) -> np.ndarray:
    """Encrypt N AES blocks at once. blocks: (N, 16) uint8 -> (N, 16) uint8.

    ``round_keys`` is either (rounds+1, 4) — one key schedule for every
    block — or (N, rounds+1, 4) — per-block schedules, which is what lets
    ``ctr_keystream_many`` run N differently-keyed chunks through a single
    T-table pass (the round-key XOR broadcasts per row; the table gathers
    are key-independent)."""
    n = blocks.shape[0]
    per_block = round_keys.ndim == 3
    rk = (lambda r: round_keys[:, r]) if per_block else (lambda r: round_keys[r])
    # to (N,4) big-endian uint32 columns
    s = blocks.reshape(n, 4, 4).astype(np.uint32)
    cols = (s[:, :, 0] << 24) | (s[:, :, 1] << 16) | (s[:, :, 2] << 8) | s[:, :, 3]
    cols = cols ^ rk(0)
    rounds = round_keys.shape[-2] - 1
    for r in range(1, rounds):
        b0 = (cols >> 24) & 0xFF
        b1 = (cols >> 16) & 0xFF
        b2 = (cols >> 8) & 0xFF
        b3 = cols & 0xFF
        j = np.arange(4)
        cols = (_T0[b0[:, j]] ^ _T1[b1[:, (j + 1) % 4]]
                ^ _T2[b2[:, (j + 2) % 4]] ^ _T3[b3[:, (j + 3) % 4]]
                ^ rk(r))
    # final round: SubBytes + ShiftRows, no MixColumns
    b0 = _SBOX[(cols >> 24) & 0xFF].astype(np.uint32)
    b1 = _SBOX[(cols >> 16) & 0xFF].astype(np.uint32)
    b2 = _SBOX[(cols >> 8) & 0xFF].astype(np.uint32)
    b3 = _SBOX[cols & 0xFF].astype(np.uint32)
    j = np.arange(4)
    cols = ((b0[:, j] << 24) | (b1[:, (j + 1) % 4] << 16)
            | (b2[:, (j + 2) % 4] << 8) | b3[:, (j + 3) % 4]) ^ rk(rounds)
    out = np.empty((n, 4, 4), dtype=np.uint8)
    out[:, :, 0] = (cols >> 24) & 0xFF
    out[:, :, 1] = (cols >> 16) & 0xFF
    out[:, :, 2] = (cols >> 8) & 0xFF
    out[:, :, 3] = cols & 0xFF
    return out.reshape(n, 16)


def encrypt_block(block: bytes, key: bytes) -> bytes:
    rk = expand_key(key)
    return encrypt_blocks(np.frombuffer(block, np.uint8).reshape(1, 16), rk).tobytes()


# ------------------------------------------------------------------- CTR

def ctr_keystream(key: bytes, iv16: bytes, nblocks: int, counter0: int = 0) -> np.ndarray:
    """Keystream of ``nblocks`` 16-byte blocks. iv16 is the full 16-byte
    initial counter block; successive blocks increment it as a 128-bit BE int."""
    base = (int.from_bytes(iv16, "big") + counter0) % (1 << 128)
    ctr = np.zeros((nblocks, 16), dtype=np.uint8)
    _counter_blocks(base.to_bytes(16, "big"), nblocks, ctr)
    return encrypt_blocks(ctr, expand_key(key))


def ctr_encrypt(data: bytes, key: bytes, iv16: bytes = b"\x00" * 16) -> bytes:
    """AES-CTR; encryption == decryption. Deterministic zero IV is safe in
    the convergent scheme because each key encrypts exactly one plaintext."""
    n = len(data)
    nblocks = (n + 15) // 16
    ks = ctr_keystream(key, iv16, nblocks).reshape(-1)[:n]
    buf = np.frombuffer(data, np.uint8) ^ ks
    return buf.tobytes()


ctr_decrypt = ctr_encrypt


def _counter_blocks(iv16: bytes, nblocks: int, out: np.ndarray):
    """Fill ``out`` (nblocks, 16) with successive CTR blocks from iv16."""
    base = int.from_bytes(iv16, "big")
    lo = base & 0xFFFFFFFFFFFFFFFF
    hi = base >> 64
    if lo + nblocks <= 0xFFFFFFFFFFFFFFFF:
        lo_vals = lo + np.arange(nblocks, dtype=np.uint64)
        out[:, 8:] = lo_vals.astype(">u8").view(np.uint8).reshape(nblocks, 8)
        out[:, :8] = np.frombuffer(hi.to_bytes(8, "big"), np.uint8)
    else:
        for i in range(nblocks):
            out[i] = np.frombuffer(
                ((base + i) % (1 << 128)).to_bytes(16, "big"), np.uint8)


def ctr_keystream_many(keys: list, nbytes: list, ivs: list | None = None,
                       *, encrypt_many=None) -> list:
    """Keystreams for N independently-keyed CTR streams in ONE batched
    T-table pass: every chunk's counter blocks are stacked into a single
    (sum(blocks), 16) array, round keys are repeated per chunk into a
    (sum(blocks), rounds+1, 4) schedule, and one ``encrypt_blocks`` call
    produces all keystreams. This is the decode-stage hot path: per-call
    numpy dispatch overhead amortizes over the whole batch instead of
    being paid once per chunk (the GIL-thrash the ROADMAP called out).

    keys: per-stream AES keys (all the same length — one rounds count).
    nbytes: per-stream keystream length in bytes.
    ivs: per-stream 16-byte initial counter blocks (default all-zero).
    encrypt_many: optional drop-in for the (blocks, per-block round keys)
    -> blocks core — the port's AES kernel (``kernels.aes``) plugs in
    here.

    Returns a list of (nbytes[i],) uint8 keystream arrays.
    """
    n = len(keys)
    if n == 0:
        return []
    assert len(set(len(k) for k in keys)) == 1, "one key size per batch"
    if ivs is None:
        ivs = [b"\x00" * 16] * n
    nblocks = [(b + 15) // 16 for b in nbytes]
    total = int(sum(nblocks))
    if total == 0:
        return [np.empty(0, np.uint8) for _ in range(n)]
    ctr = np.zeros((total, 16), dtype=np.uint8)
    off = 0
    for iv, nb in zip(ivs, nblocks):
        if nb:
            _counter_blocks(iv, nb, ctr[off:off + nb])
        off += nb
    # every convergent chunk has its own key: expand all N schedules in
    # one vectorized pass instead of N pure-python loops
    per_key = expand_keys_many(keys)
    if encrypt_many is not None and getattr(encrypt_many, "per_chunk_rks",
                                            False):
        # run-length protocol: ship ONE schedule per chunk plus block
        # counts; the backend broadcasts on device (no host np.repeat
        # of 60-word schedules per 16-byte block)
        ks = np.asarray(encrypt_many(
            ctr, per_key,
            counts=np.asarray(nblocks, np.int64))).reshape(total * 16)
    else:
        rks = np.repeat(per_key, nblocks, axis=0)
        fn = encrypt_many or encrypt_blocks
        ks = np.asarray(fn(ctr, rks)).reshape(total * 16)
    out = []
    off = 0
    for nb, want in zip(nblocks, nbytes):
        out.append(ks[off * 16:off * 16 + want])
        off += nb
    return out


def ctr_decrypt_many(datas: list, keys: list, ivs: list | None = None,
                     *, encrypt_many=None) -> list:
    """Batched AES-CTR over N buffers (encryption == decryption)."""
    ks = ctr_keystream_many(keys, [len(d) for d in datas], ivs,
                            encrypt_many=encrypt_many)
    return [(np.frombuffer(d, np.uint8) ^ k).tobytes()
            for d, k in zip(datas, ks)]


# ------------------------------------------------------------------- GCM

def _shoup_table(h_int: int) -> list:
    """M[b] = (b as an 8-bit polynomial) * H, for byte-serial GHASH."""
    table = [0] * 256
    table[0x80] = h_int          # x^0 coefficient sits at the MSB
    v = h_int
    for i in range(1, 8):        # table[0x80 >> i] = H * x^i
        v = (v >> 1) ^ (0xE1000000000000000000000000000000 if v & 1 else 0)
        table[0x80 >> i] = v
    for b in range(256):
        if b and not table[b]:
            hi = 1 << (b.bit_length() - 1)
            table[b] = table[hi] ^ table[b ^ hi]
    return table


# z * x^8 reduction table: R8[(z & 0xff)] to fold the low byte back in
_R8 = None


def _r8_table() -> list:
    global _R8
    if _R8 is None:
        R = 0xE1000000000000000000000000000000
        tab = [0] * 256
        for b in range(256):
            z = b
            for _ in range(8):
                z = (z >> 1) ^ (R if z & 1 else 0)
            tab[b] = z
        _R8 = tab
    return _R8


def ghash(h: bytes, data: bytes) -> bytes:
    """GHASH over data (zero-padded to 16B blocks). Byte-serial Shoup
    tables: ~16 table lookups per block instead of a 128-step bit loop —
    what makes opening multi-GiB-image manifests practical."""
    h_int = int.from_bytes(h, "big")
    table = _shoup_table(h_int)
    r8 = _r8_table()
    y = 0
    for i in range(0, len(data), 16):
        block = data[i:i + 16].ljust(16, b"\x00")
        y ^= int.from_bytes(block, "big")
        z = 0
        # LSB byte first: it carries the highest powers of x (GCM's
        # reflected bit order), so Horner shifts it deepest
        for byte in reversed(y.to_bytes(16, "big")):
            z = (z >> 8) ^ r8[z & 0xFF] ^ table[byte]
        y = z
    return y.to_bytes(16, "big")


def gcm_encrypt(key: bytes, nonce12: bytes, plaintext: bytes,
                aad: bytes = b"") -> tuple[bytes, bytes]:
    """AES-GCM. Returns (ciphertext, 16-byte tag)."""
    h = encrypt_block(b"\x00" * 16, key)
    j0 = nonce12 + b"\x00\x00\x00\x01"
    ct = ctr_keystream_xor(key, j0, plaintext)
    lens = (len(aad) * 8).to_bytes(8, "big") + (len(ct) * 8).to_bytes(8, "big")
    pad = lambda b: b + b"\x00" * ((-len(b)) % 16)
    s = ghash(h, pad(aad) + pad(ct) + lens)
    ek_j0 = encrypt_block(j0, key)
    tag = bytes(a ^ b for a, b in zip(s, ek_j0))
    return ct, tag


def ctr_keystream_xor(key: bytes, j0: bytes, data: bytes) -> bytes:
    """GCM body encryption: CTR starting at inc32(J0)."""
    n = len(data)
    nblocks = (n + 15) // 16
    rk = expand_key(key)
    prefix = j0[:12]
    c0 = int.from_bytes(j0[12:], "big")
    ctr = np.zeros((nblocks, 16), dtype=np.uint8)
    ctr[:, :12] = np.frombuffer(prefix, np.uint8)
    cvals = ((c0 + 1 + np.arange(nblocks, dtype=np.uint64)) & 0xFFFFFFFF).astype(">u4")
    ctr[:, 12:] = cvals.view(np.uint8).reshape(nblocks, 4)
    ks = encrypt_blocks(ctr, rk).reshape(-1)[:n]
    return (np.frombuffer(data, np.uint8) ^ ks).tobytes()


def gcm_decrypt(key: bytes, nonce12: bytes, ciphertext: bytes, tag: bytes,
                aad: bytes = b"") -> bytes:
    """Raises ValueError on authentication failure."""
    h = encrypt_block(b"\x00" * 16, key)
    j0 = nonce12 + b"\x00\x00\x00\x01"
    lens = (len(aad) * 8).to_bytes(8, "big") + (len(ciphertext) * 8).to_bytes(8, "big")
    pad = lambda b: b + b"\x00" * ((-len(b)) % 16)
    s = ghash(h, pad(aad) + pad(ciphertext) + lens)
    ek_j0 = encrypt_block(j0, key)
    expect = bytes(a ^ b for a, b in zip(s, ek_j0))
    if not _const_eq(expect, tag):
        raise ValueError("GCM tag mismatch: ciphertext corrupt or tampered")
    return ctr_keystream_xor(key, j0, ciphertext)


def _const_eq(a: bytes, b: bytes) -> bool:
    if len(a) != len(b):
        return False
    r = 0
    for x, y in zip(a, b):
        r |= x ^ y
    return r == 0
