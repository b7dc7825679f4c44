"""CPU tests of the benchmark's plain reference: its AES against FIPS-197
and against the program's cipher, its MessagePack decoder, and the
write-path check on a real publish, sound and tampered."""
from __future__ import annotations

import hashlib

import numpy as np
import pytest

import bench_cpu_cells  # noqa: F401  (puts bench/ and src/ on the path)
from benchkit import aes_ref, msgpack_ref, reference


def test_aes256_fips197_vector():
    key = bytes(range(32))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    ct = aes_ref.encrypt_blocks(np.frombuffer(pt, np.uint8)[None],
                                aes_ref.expand_key(key))
    assert ct.tobytes().hex() == "8ea2b7ca516745bfeafc49904b496089"


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 4096 + 5])
def test_ctr_and_gcm_agree_with_the_program(n):
    from repro_torch.core.crypto import aes
    rng = np.random.default_rng(n)
    data, key = rng.bytes(n), rng.bytes(32)
    assert aes_ref.ctr_xor(data, key) == aes.ctr_encrypt(data, key)
    nonce = rng.bytes(12)
    ct, _ = aes.gcm_encrypt(key, nonce, data)
    assert aes_ref.gcm_ctr_xor(ct, key, nonce) == data


def test_msgpack_decoder_reads_the_program_encoding():
    from repro_torch.core import _msgpack
    obj = {"image_id": "ab" * 16, "n": [0, 1, 127, 128, 65535, 1 << 40, -1,
                                        -33, -(1 << 20)],
           "salt": b"\x00" * 16, "chunks": [[i, "x" * 64, bytes(32)]
                                            for i in range(20)],
           "nested": {"t": True, "f": False, "none": None, "s": "é" * 40}}
    assert msgpack_ref.unpack(_msgpack.packb(obj)) == obj


def _published(tmp_path):
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    rng = np.random.default_rng(7)
    tree = {"a/w": rng.standard_normal((40, 300), dtype=np.float32),
            "a/z": np.zeros((5000,), np.float32),
            "b": rng.standard_normal((7,), dtype=np.float32)}
    store = ChunkStore(tmp_path)
    svc = ImageService(store, ServiceConfig(device="cpu", root="r0",
                                            decode_backend="python"))
    key = hashlib.sha256(b"k").digest()
    blob, _ = svc.publish(tree, tenant="t", tenant_key=key, root="r0",
                          chunk_size=16384)
    svc.close()
    return tree, blob, key


def test_check_image_sound_and_tampered(tmp_path):
    tree, blob, key = _published(tmp_path)
    kw = dict(store_dir=tmp_path, root="r0", tenant="t", chunk_size=16384)
    _, size = reference.layout(tree, 16384)
    every = list(range(size // 16384))
    assert reference.check_image(blob, key, tree, sample=every, **kw) == {
        "manifest": 0, "chunks": 0, "ciphertexts": 0}
    # another tenant's name, and another tree, are both found
    assert reference.check_image(blob, key, tree, **{**kw, "tenant": "u"}
                                 )["manifest"] == 1
    other = dict(tree, b=tree["b"] + 1)
    bad = reference.check_image(blob, key, other, **kw)
    assert bad["manifest"] >= 1 and bad["chunks"] == 1
    # a stored ciphertext altered in place, its name left as it was
    name = msgpack_ref.unpack(msgpack_ref.unpack(blob)["body"])["chunks"][0][1]
    path = reference.chunk_path(tmp_path, "r0", name)
    raw = bytearray(path.read_bytes())
    raw[100] ^= 1
    path.write_bytes(bytes(raw))
    bad = reference.check_image(blob, key, tree, sample=[0], **kw)
    assert bad == {"manifest": 0, "chunks": 1, "ciphertexts": 1}


def test_distinct_chunks_counts_plaintexts_once():
    a = np.arange(4096 * 2, dtype=np.float32)
    tree = {"x": a, "y": a.copy(), "z": np.zeros(4096, np.float32)}
    # x and y: two chunks of 16 KiB each, the same two; z all zero
    assert reference.distinct_chunks(tree, 16384) == 2
