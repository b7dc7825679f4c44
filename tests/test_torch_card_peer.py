"""The fused verify+decrypt kernel launched from several threads at once,
as the workers of a cold-start storm launch it (each worker's streamed
decode calls the kernel on its own thread, on PyTorch's current stream
of that thread). Three threads each decode their own tile of chunks,
repeatedly, after a common barrier; one thread's tile carries a
one-byte tamper. Each thread's digests and plaintexts must equal the
plain version's and the hashlib/AES-CTR oracles, and only the tampered thread
may raise ``IntegrityError``, naming its chunk. Exact bytes.

Each thread computes its plain reference on its own thread, beside the
other threads' launches: on a card the plain SHA-256 captures a CUDA
graph, and that capture must hold while other threads launch kernels,
copy and allocate. A second test makes that overlap certain: three
threads each alternate the plain version and the kernel on their own
tile, so every capture runs while the others launch.

On the CPU the threads run the plain version; marked ``cuda`` they
launch the kernel on a card:

    python -m pytest -m cuda tests/test_torch_card_peer.py

This file imports neither the JAX package nor jax."""
import hashlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core.crypto import aes, convergent  # noqa: E402
from repro_torch.kernels.fused import ops as fops  # noqa: E402
from repro_torch.kernels.sha256 import ops as sops  # noqa: E402

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
THREADS = 3
TAMPERED = 1                        # the thread whose tile is tampered
SALT = b"storm-test-salt!"


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device(name)


def _tile(seed: int, n: int, size: int) -> list:
    rng = np.random.default_rng(seed)
    return [convergent.encrypt_chunk(
        rng.integers(0, 256, size, dtype=np.uint8).tobytes(), SALT)
        for _ in range(n)]


@pytest.mark.parametrize("device", DEVICES)
def test_fused_kernel_from_concurrent_threads(device):
    dev = _device(device)
    n, size, reps = (8, 64 << 10, 4) if dev.type == "cuda" else (3, 200, 1)
    tiles = [_tile(t, n, size) for t in range(THREADS)]
    bad_at = n // 2
    cts = [[e.ciphertext for e in tile] for tile in tiles]
    flipped = bytearray(cts[TAMPERED][bad_at])
    flipped[len(flipped) // 3] ^= 0x40
    cts[TAMPERED][bad_at] = bytes(flipped)
    barrier = threading.Barrier(THREADS)
    errors, raised = [], {}
    before = kernels.LAUNCHES["fused_verify_decrypt"]

    def work(t):
        try:
            tile, mine = tiles[t], cts[t]
            keys = [e.key for e in tile]
            packed = sops.to_device(*sops.pack_messages(mine), dev)
            rks = torch.from_numpy(fops.round_keys(keys).view(np.int32)) \
                .to(dev)
            want = [hashlib.sha256(c).digest() for c in mine]
            barrier.wait(timeout=60)
            # the plain reference, while the other threads launch
            pp, pdig = fops.fused_lanes_plain(*packed, rks)
            ref, pdig = pp.cpu().numpy(), pdig.cpu()
            for _ in range(reps):
                plain, dig = fops.fused_verify_decrypt_lanes(*packed, rks)
                assert torch.equal(dig.cpu(), pdig)
                assert [bytes(d) for d in dig.cpu().numpy()] == want
                buf = plain.cpu().numpy()
                for c, k, o in zip(mine, keys, packed[1].tolist()):
                    got = buf[o:o + len(c)]
                    assert np.array_equal(got, ref[o:o + len(c)])
                    assert got.tobytes() == aes.ctr_decrypt(c, k)
                try:
                    out = convergent.decrypt_chunks(
                        mine, keys, [e.sha256 for e in tile],
                        fused=lambda c, k: fops.fused_verify_decrypt(
                            c, k, device=dev))
                except convergent.IntegrityError as e:
                    raised[t] = e.bad_positions
                else:
                    assert out == [aes.ctr_decrypt(c, k)
                                   for c, k in zip(mine, keys)]
        except Exception as e:          # reported by the assertion below
            errors.append((t, repr(e)))
    threads = [threading.Thread(target=work, args=(t,))
               for t in range(THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert raised == {TAMPERED: [bad_at]}
    if dev.type == "cuda":
        # per rep one tensor launch and one through the hook, per thread
        assert kernels.LAUNCHES["fused_verify_decrypt"] - before == \
            2 * reps * THREADS


@pytest.mark.parametrize("device", DEVICES)
def test_plain_version_beside_other_threads_launches(device):
    """Three threads, eight 64 KiB chunks each: each alternates the
    plain version (its SHA-256 captures a CUDA graph on a card) and the
    kernel on its own tile, starting on opposite sides of the pair, so
    each capture overlaps the other threads' kernel launches. Every
    plain result equals the kernel's, and the digests hashlib's."""
    dev = _device(device)
    n, size, reps = (8, 64 << 10, 3) if dev.type == "cuda" else (3, 200, 1)
    tiles = [_tile(10 + t, n, size) for t in range(THREADS)]
    barrier = threading.Barrier(THREADS)
    errors = []
    before = kernels.LAUNCHES["fused_verify_decrypt"]

    def work(t):
        try:
            tile = tiles[t]
            mine = [e.ciphertext for e in tile]
            keys = [e.key for e in tile]
            packed = sops.to_device(*sops.pack_messages(mine), dev)
            rks = torch.from_numpy(fops.round_keys(keys).view(np.int32)) \
                .to(dev)
            want = [hashlib.sha256(c).digest() for c in mine]
            runs = [fops.fused_lanes_plain, fops.fused_verify_decrypt_lanes]
            if t % 2:
                runs.reverse()
            barrier.wait(timeout=60)
            for _ in range(reps):
                (p0, d0), (p1, d1) = [run(*packed, rks) for run in runs]
                assert torch.equal(p0.cpu(), p1.cpu())
                assert torch.equal(d0.cpu(), d1.cpu())
                assert [bytes(d) for d in d0.cpu().numpy()] == want
        except Exception as e:          # reported by the assertion below
            errors.append((t, repr(e)))
    threads = [threading.Thread(target=work, args=(t,))
               for t in range(THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    if dev.type == "cuda":
        assert kernels.LAUNCHES["fused_verify_decrypt"] - before == \
            reps * THREADS
