"""The port's SHA-256, fused verify+decrypt and AES wrappers on the
inputs their kernels make risky. For the warp-specialised SHA engine
(``csrc/sha256_engine.cuh``): one group mixing lengths 0 to 512 KiB,
batch sizes that are not multiples of the group size G (32 messages per
block for SHA-256, 8 for the fused kernel), message starts off the
16-byte grid, and the key-derivation length (a 16-byte salt and a
512 KiB chunk). For the AES kernel (``csrc/aes.cu``): the cases listed
above its tests below. Oracles: hashlib and the port's numpy AES; exact
bytes.

Each case runs on the CPU through the plain versions (at lengths a CPU
hashes in seconds) and, marked ``cuda``, through the kernels on a card:

    python -m pytest -m cuda tests/test_torch_card.py

This file imports neither the JAX package nor jax, so it runs on a
machine with a card and no jax."""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.crypto import aes  # noqa: E402
from repro_torch.kernels.aes import ops as aops  # noqa: E402
from repro_torch.kernels.fused import ops as fops  # noqa: E402
from repro_torch.kernels.sha256 import ops as sops  # noqa: E402

KIB512 = 512 << 10
KEY_DERIVATION = 16 + KIB512        # salt || chunk, hashed on publish
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device(name)


def _pack(msgs: list, misalign: bool) -> tuple:
    """(buf, offsets, lengths) numpy arrays; with `misalign` message i
    starts at 1 + i % 15 bytes past a 16-byte boundary."""
    if not misalign:
        return sops.pack_messages(msgs)
    offsets, end = [], 0
    for i, m in enumerate(msgs):
        o = (end + 15) // 16 * 16 + 1 + i % 15
        offsets.append(o)
        end = o + len(m)
    buf = np.random.default_rng(0).integers(0, 256, end + 7, dtype=np.uint8)
    for m, o in zip(msgs, offsets):
        buf[o:o + len(m)] = np.frombuffer(m, np.uint8)
    return (buf, np.array(offsets, np.int64),
            np.array([len(m) for m in msgs], np.int64))


def _check(dev, lengths, seed: int, misalign=False) -> None:
    """Both wrappers on messages of `lengths` against hashlib and AES-CTR,
    and, on the card for short messages, against their plain versions."""
    rng = np.random.default_rng(seed)
    msgs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in lengths]
    keys = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in msgs]
    buf, offsets, lens = _pack(msgs, misalign)
    if misalign:
        assert all(o % 16 for o in offsets)
    t = sops.to_device(buf, offsets, lens, dev)
    rks = torch.from_numpy(fops.round_keys(keys).view(np.int32)).to(dev)
    want = np.frombuffer(b"".join(hashlib.sha256(m).digest() for m in msgs),
                         np.uint8).reshape(-1, 32)
    dig = sops.sha256_lanes(*t)
    plain, fdig = fops.fused_verify_decrypt_lanes(*t, rks)
    assert np.array_equal(dig.cpu().numpy(), want)
    assert np.array_equal(fdig.cpu().numpy(), want)
    pn = plain.cpu().numpy()
    for m, k, o in zip(msgs, keys, offsets):
        assert pn[o:o + len(m)].tobytes() == aes.ctr_decrypt(m, k)
    if dev.type == "cuda" and max(lengths) <= 4096:
        assert torch.equal(dig, sops.sha256_lanes_plain(*t))
        pp, pdig = fops.fused_lanes_plain(*t, rks)
        assert torch.equal(fdig, pdig)
        for o, n in zip(offsets.tolist(), lens.tolist()):
            assert torch.equal(plain[o:o + n], pp[o:o + n])


@pytest.mark.parametrize("device", DEVICES)
def test_one_group_of_mixed_lengths(device):
    """Lengths 0, 1, 55, 64, 65 and a long message in one group of both
    kernels: every padding case, and lanes that freeze while one runs on
    (512 KiB on the card, 300 bytes on the CPU)."""
    dev = _device(device)
    long = KIB512 if dev.type == "cuda" else 300
    _check(dev, [0, 1, 55, 64, 65, long], seed=8)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("n", [1, 31, 33, 257])
def test_batch_sizes_off_the_group_size(device, n):
    """N messages of random lengths, N not a multiple of either G: the last
    group's missing lanes must neither write nor stall the others."""
    dev = _device(device)
    top = 3000 if dev.type == "cuda" else 150
    lengths = np.random.default_rng(n).integers(0, top, n)
    _check(dev, lengths, seed=n)


@pytest.mark.parametrize("device", DEVICES)
def test_unaligned_starts(device):
    """Message starts at 1..15 bytes past a 16-byte boundary, given to
    the tensor wrappers directly: the engine's byte path."""
    dev = _device(device)
    long = 5000 if dev.type == "cuda" else 200
    lengths = [0, 1, 55, 56, 63, 64, 65, 127, 128, 129, 300, long, 17, 31,
               48, 4096 if dev.type == "cuda" else 100]
    _check(dev, lengths, seed=15, misalign=True)


@pytest.mark.cuda
def test_key_derivation_length_on_card():
    """A salt and a 512 KiB chunk, 524,304 bytes (8193 blocks, the last
    one all padding), aligned and not, beside a short message."""
    dev = _device("cuda")
    _check(dev, [KEY_DERIVATION, 10], seed=524304)
    _check(dev, [KEY_DERIVATION, 10], seed=524305, misalign=True)


@pytest.mark.cuda
def test_kernels_on_card():
    """The three crypto kernels against the oracles, each launched once
    (run on a machine with a card: ``pytest -m cuda``)."""
    dev = _device("cuda")
    from repro_torch import kernels
    rng = np.random.default_rng(1105)
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (0, 1, 55, 56, 63, 64, 65, 4096, 70_000)]
    keys = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in msgs]
    called = ("sha256_many", "fused_verify_decrypt", "aes_encrypt_many")
    before = dict(kernels.LAUNCHES)
    assert sops.sha256_many(msgs, device=dev) == \
        [hashlib.sha256(m).digest() for m in msgs]
    dig, pts = fops.fused_verify_decrypt(msgs, keys, device=dev)
    assert dig == [hashlib.sha256(m).digest() for m in msgs]
    assert pts == [aes.ctr_decrypt(m, k) for m, k in zip(msgs, keys)]
    rks = aes.expand_keys_many(keys)
    blocks = rng.integers(0, 256, (len(keys) * 40, 16), dtype=np.uint8)
    counts = np.full(len(keys), 40)
    assert np.array_equal(
        aops.encrypt_many(blocks, rks, counts=counts, device=dev),
        aops.encrypt_many(blocks, rks, counts=counts, device="cpu"))
    assert all(kernels.LAUNCHES[k] == before[k] + 1 for k in called)


@pytest.mark.cuda
def test_launch_geometry_on_card():
    """The geometry the launch functions report: one block per group of
    G, and the fused kernel's CTR blocks filling the card's other SMs."""
    _device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    s = sops.geometry(257)
    assert s["group"] == 32 and s["blocks"] == -(-257 // 32)
    assert s["threads"] == 32 * s["warps"]
    f = fops.geometry(257)
    hb = f["hash_blocks"]
    assert f["group"] == 8 and hb == -(-257 // 8)
    assert f["ctr_blocks"] == (sms - hb if hb < sms else sms)
    assert f["smem_bytes"] >= s["smem_bytes"]


# ------------------------------------------------------------------ AES
# The AES kernel's risky inputs: tiles and warps straddling chunks, block
# counts off the warp size, one schedule per block (the kernel then reads
# its keys from device memory), AES-128, every byte value at every state
# position and lane, and the FIPS-197 example vectors (Appendix C.1 and
# C.3: key bytes 00 01 02 ..., plaintext 00 11 22 ... ff).
FIPS197_PLAIN = bytes.fromhex("00112233445566778899aabbccddeeff")
FIPS197 = {16: "69c4e0d86a7b0430d8cdb78070b4c55a",
           32: "8ea2b7ca516745bfeafc49904b496089"}


def _aes_check(dev, blocks, keys, idx) -> np.ndarray:
    """The tensor wrapper on `dev` against ``aes.encrypt_blocks`` and, on
    the card, the plain version; returns the ciphertext."""
    rks = aes.expand_keys_many(keys)
    b = torch.from_numpy(blocks).to(dev)
    r = torch.from_numpy(rks.view(np.int32)).to(dev)
    i = torch.from_numpy(np.asarray(idx, np.int32)).to(dev)
    got = aops.aes_encrypt_blocks(b, r, i)
    out = got.cpu().numpy()
    assert np.array_equal(out, aes.encrypt_blocks(blocks, rks[idx]))
    if dev.type == "cuda":
        assert torch.equal(got, aops.aes_encrypt_blocks_plain(b, r, i))
    return out


def _aes_inputs(seed: int, counts, key_size=32):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 256, key_size, dtype=np.uint8).tobytes()
            for _ in counts]
    blocks = rng.integers(0, 256, (int(sum(counts)), 16), dtype=np.uint8)
    return blocks, keys, np.repeat(np.arange(len(counts)), counts)


@pytest.mark.parametrize("device", DEVICES)
def test_aes_chunk_boundaries(device):
    """Runs of 1, 31, 33, 40 and 32768 blocks (64 on the CPU) in one
    call, through the tensor wrapper and the run-length host hook."""
    dev = _device(device)
    counts = (1, 31, 33, 40, 32768 if dev.type == "cuda" else 64)
    blocks, keys, idx = _aes_inputs(14, counts)
    _aes_check(dev, blocks, keys, idx)
    rks = aes.expand_keys_many(keys)
    assert np.array_equal(
        aops.encrypt_many(blocks, rks, counts=np.array(counts), device=dev),
        aes.encrypt_blocks(blocks, rks[idx]))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("n", [1, 31, 33, 257])
def test_aes_block_counts(device, n):
    """N blocks under one schedule each, and in three runs."""
    dev = _device(device)
    blocks, keys, _ = _aes_inputs(n, [1] * n)
    _aes_check(dev, blocks, keys, np.arange(n))
    split = np.sort(np.random.default_rng(n).integers(0, n + 1, 2))
    blocks, keys, idx = _aes_inputs(n + 1, np.diff([0, *split, n]))
    _aes_check(dev, blocks, keys, idx)


@pytest.mark.parametrize("device", DEVICES)
def test_aes_128(device):
    """(C, 11, 4) schedules, in runs and one per block."""
    dev = _device(device)
    _aes_check(dev, *_aes_inputs(128, (7, 300, 2000), key_size=16))
    blocks, keys, _ = _aes_inputs(129, [1] * 257, key_size=16)
    _aes_check(dev, blocks, keys, np.arange(257))


@pytest.mark.parametrize("device", DEVICES)
def test_aes_every_byte_value(device):
    """Block i holds byte (i // 32) % 256 in all 16 positions, so in the
    first round every lane of a warp looks up every byte value at every
    position: a wrong entry of a replicated table shows on its own."""
    dev = _device(device)
    blocks = np.repeat(((np.arange(256 * 32) // 32) % 256)
                       .astype(np.uint8)[:, None], 16, axis=1)
    _, keys, _ = _aes_inputs(256, [1])
    _aes_check(dev, blocks, keys, np.zeros(len(blocks), np.int64))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("key_size", [16, 32])
def test_aes_fips197_vectors(device, key_size):
    dev = _device(device)
    out = _aes_check(dev, np.frombuffer(FIPS197_PLAIN, np.uint8)[None].copy(),
                     [bytes(range(key_size))], np.zeros(1, np.int64))
    assert out.tobytes().hex() == FIPS197[key_size]


@pytest.mark.cuda
def test_aes_launch_geometry_on_card():
    """Persistent blocks: the SM count times the blocks an SM holds, at
    the publish tile; fewer when the blocks make fewer tiles."""
    _device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = aops.geometry(8_388_608)
    assert g["sms"] == sms and g["blocks_per_sm"] >= 1
    assert g["grid"] == sms * g["blocks_per_sm"]
    tile = g["threads"] * g["blocks_per_thread"]
    assert aops.geometry(3 * tile)["grid"] == 3
