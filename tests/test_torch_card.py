"""The port's SHA-256 and fused verify+decrypt wrappers on the inputs the
warp-specialised SHA engine (``csrc/sha256_engine.cuh``) makes risky:
one group mixing lengths 0 to 512 KiB, batch sizes that are not
multiples of the group size G (32 messages per block for SHA-256, 8 for
the fused kernel), message starts off the 16-byte grid, and
the key-derivation length (a 16-byte salt and a 512 KiB chunk). Oracles:
hashlib and the port's numpy AES-CTR; exact bytes.

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
