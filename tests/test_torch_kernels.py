"""The port's three crypto kernels, through their plain PyTorch versions
on the CPU, against the JAX package's reference implementations (its
numpy lockstep SHA-256, T-table AES and CTR, per-chunk
verify-then-decrypt, and the bitsliced AES Pallas kernel in interpret
mode on a few blocks) and hashlib. The JAX package's SHA-256 Pallas and
fused jit routes are not called here: compiling either for one small
batch takes many minutes on a CPU. Tolerance: exact bytes. The CUDA
kernels themselves run only on the card, in ``tests/test_torch_card.py``
(marked ``cuda``), which imports no JAX so that it runs there."""
import functools
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.crypto import aes, convergent  # noqa: E402
from repro.core.crypto.sha256v import sha256_many_np  # noqa: E402
from repro.kernels.aes.ops import encrypt_many_bitsliced  # noqa: E402
from repro_torch.core.crypto import aes as port_aes  # noqa: E402
from repro_torch.kernels.aes import ops as aops  # noqa: E402
from repro_torch.kernels.fused import ops as fops  # noqa: E402
from repro_torch.kernels.sha256 import ops as sops  # noqa: E402

RNG = np.random.default_rng(1105)
BOUNDARY = [0, 1, 55, 56, 63, 64, 65, 4096]


def _rand(n):
    return RNG.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_plain_fused_matches_jax_reference_and_oracles():
    """Boundary lengths plus mixed-key lanes (one key shared by three
    lanes) in one batch, against the JAX package's batched two-pass
    ``decrypt_chunks`` and its per-chunk ``decrypt_chunk``."""
    cts = [_rand(n) for n in BOUNDARY + [17, 300, 300]]
    keys = [_rand(32) for _ in BOUNDARY] + [_rand(32)] * 3
    dig, pts = fops.fused_verify_decrypt(cts, keys, device="cpu")
    assert pts == convergent.decrypt_chunks(cts, keys, dig)
    for ct, k, d, p in zip(cts, keys, dig, pts):
        assert d == hashlib.sha256(ct).digest()
        assert p == convergent.decrypt_chunk(ct, k, d)
    assert fops.fused_verify_decrypt([], [], device="cpu") == ([], [])


def test_plain_sha_matches_numpy_lockstep_and_hashlib():
    short = [_rand(n) for n in (0, 1, 31, 55, 56, 63, 64, 65)]
    assert sops.sha256_many(short, device="cpu") == sha256_many_np(short)
    wide = [_rand(n) for n in BOUNDARY + [127, 128, 129, 1000, 2048]]
    assert sops.sha256_many(wide, device="cpu") == \
        [hashlib.sha256(m).digest() for m in wide]


@pytest.mark.parametrize("n", BOUNDARY + [512 << 10])
def test_port_aes_copy_matches_jax_package(n):
    """The port's own copy of the AES module, the card tests' oracle
    (``tests/test_torch_card.py``), against the JAX package's: CTR of
    `n` bytes, batched key schedules and block encryption."""
    rng = np.random.default_rng(n)
    keys = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
            for _ in range(3)]
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    for k in keys:
        assert port_aes.ctr_decrypt(data, k) == aes.ctr_decrypt(data, k)
    rks = aes.expand_keys_many(keys)
    assert np.array_equal(port_aes.expand_keys_many(keys), rks)
    blocks = rng.integers(0, 256, (max(1, n // 16), 16), dtype=np.uint8)
    per_block = rks[np.arange(len(blocks)) % len(keys)]
    for schedule in (rks[0], per_block):
        assert np.array_equal(port_aes.encrypt_blocks(blocks, schedule),
                              aes.encrypt_blocks(blocks, schedule))


def test_plain_aes_matches_encrypt_blocks_and_ctr():
    keys = [_rand(32) for _ in BOUNDARY]
    hook = functools.partial(aops.encrypt_many, device="cpu")
    hook.per_chunk_rks = True
    ks = aes.ctr_keystream_many(keys, BOUNDARY, encrypt_many=hook)
    for k, n, got in zip(keys, BOUNDARY, ks):
        assert got.tobytes() == aes.ctr_encrypt(b"\x00" * n, k)
    counts = np.array([300, 0, 257, 64])
    keys = [_rand(32) for _ in counts]
    rks = aes.expand_keys_many(keys)
    blocks = RNG.integers(0, 256, (int(counts.sum()), 16), dtype=np.uint8)
    got = aops.encrypt_many(blocks, rks, counts=counts, device="cpu")
    assert np.array_equal(got, aes.encrypt_blocks(
        blocks, np.repeat(rks, counts, axis=0)))
    # the JAX package's bitsliced Pallas route (interpret mode on the
    # CPU), on a few blocks: one lane bucket, one compile
    few = np.array([2, 0, 3, 3])
    assert np.array_equal(
        aops.encrypt_many(blocks[:8], rks, counts=few, device="cpu"),
        encrypt_many_bitsliced(blocks[:8], rks, counts=few))
    # the legacy shapes of the hook: one shared or one per-block schedule
    assert np.array_equal(aops.encrypt_many(blocks[:5], rks[0], device="cpu"),
                          aes.encrypt_blocks(blocks[:5], rks[0]))
    assert np.array_equal(
        aops.encrypt_many(blocks[:4], rks, device="cpu"),
        aes.encrypt_blocks(blocks[:4], rks))


@pytest.mark.parametrize("wrapper, args", [
    ("sha", lambda d: (torch.zeros(16, dtype=torch.uint8, device=d),
                       torch.zeros(1, dtype=torch.int64, device=d),
                       torch.ones(1, dtype=torch.int64, device=d))),
    ("aes", lambda d: (torch.zeros(1, 16, dtype=torch.uint8, device=d),
                       torch.zeros(1, 15, 4, dtype=torch.int32, device=d),
                       torch.zeros(1, dtype=torch.int32, device=d))),
    ("fused", lambda d: (torch.zeros(16, dtype=torch.uint8, device=d),
                         torch.zeros(1, dtype=torch.int64, device=d),
                         torch.ones(1, dtype=torch.int64, device=d),
                         torch.zeros(1, 15, 4, dtype=torch.int32, device=d))),
])
def test_wrappers_take_plain_version_only_for_cpu_tensors(wrapper, args):
    """A tensor that is not on the CPU never reaches the plain version:
    a non-CUDA device raises, and mismatched dtypes raise too."""
    fn = {"sha": sops.sha256_lanes, "aes": aops.aes_encrypt_blocks,
          "fused": fops.fused_verify_decrypt_lanes}[wrapper]
    fn(*args("cpu"))
    with pytest.raises(ValueError):
        fn(*args("meta"))
    bad = list(args("cpu"))
    bad[0] = bad[0].to(torch.int32)
    with pytest.raises(TypeError):
        fn(*bad)
