"""The port's serial loader shim and the rest of its read API
(``repro_torch.core.loader``, ``CowBlockDevice``, ``ImageHandle``'s
shard and prefetch reads) against the JAX package's, on the CPU, over
one image the JAX package published (f32, u16, i8, a scalar and a zero
plane; 4 KiB chunks, so every chunk holds one 4 KiB page).

Exact, no tolerance: one seeded sequence of unaligned writes and reads
across page and chunk boundaries (and reads past the image end) gives
the same bytes and ``dirty_bytes`` through the port's
``CowBlockDevice`` and the JAX one; the ``ImageReader`` shims restore
the same trees in the streamed, staged and serial modes, the same
tensors, shards and shard chunk sets; ``sharding_slices`` and
``ReadPolicy.from_legacy`` agree; a prefetch warms L1 so that the
restore after it makes no origin GET.

The port runs on ``device="cpu"``: the ``python`` backend (numpy AES,
hashlib), the ``torch-fused`` backend's plain PyTorch versions and the
``serial`` oracle; the JAX side on ``numpy``."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.blockdev import CowBlockDevice as JCow  # noqa: E402
from repro.core.decode import BatchDecoder as JDecoder  # noqa: E402
from repro.core.loader import ImageReader as JReader  # noqa: E402
from repro.core.loader import sharding_slices as jsharding  # noqa: E402
from repro.core.publish import PublishPipeline as JPipeline  # noqa: E402
from repro.core.service import ReadPolicy as JPolicy  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro_torch.core.blockdev import PAGE, CowBlockDevice  # noqa: E402
from repro_torch.core.decode import BatchDecoder  # noqa: E402
from repro_torch.core.loader import ImageReader, sharding_slices  # noqa: E402
from repro_torch.core.service import ImageService, ReadPolicy, \
    ServiceConfig, single_image_service  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402

KEY = b"T" * 32
CS = 4096
SHARDS = {"w_f32": [(32, 64), (0, 96)], "w_u16": [(0, 64), (16, 48)]}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(7)
    tree = {
        "w_f32": rng.standard_normal((128, 96)).astype(np.float32),
        "w_u16": rng.integers(0, 65535, (64, 64)).astype(np.uint16),
        "w_i8": rng.integers(-128, 127, (300,)).astype(np.int8),
        "scalar": np.float32(3.25),
        "zeros": np.zeros((2048,), np.float32),
    }
    pipe = JPipeline(JStore(d), backend="numpy")
    blob, _ = pipe.publish(tree, tenant="t", tenant_key=KEY, root="R1",
                           chunk_size=CS)
    pipe.close()
    return d, tree, blob


def _readers(env, backend="python"):
    """(port, JAX) shims over the image; the port's decoder runs
    `backend` on the CPU."""
    d, _, blob = env
    dec = BatchDecoder(backend, device="cpu")
    return (ImageReader(blob, KEY, ChunkStore(d), device="cpu", decoder=dec),
            JReader(blob, KEY, JStore(d)))


def _cow_script(dev, size: int, seed: int = 3) -> list:
    """One seeded sequence of writes and reads; what each read returned
    and the dirty bytes after each write."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(40):
        off = int(rng.integers(0, size - 1))
        ln = int(rng.integers(1, min(3 * CS, size - off) + 1))
        if step % 2 == 0:
            payload = rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
            dev.write(off, payload)
            out.append(("w", off, ln, dev.dirty_bytes))
        else:
            out.append(("r", off, dev.read(off, ln + int(rng.integers(0, 64)))))
    out.append(("page-aligned", dev.write(PAGE * 2, b"q" * PAGE),
                dev.dirty_bytes))
    out.append(("past the end", dev.read(size - 100, 300)))
    out.append(("all", dev.read(0, size), dev.bitmap.tolist()))
    return out


def test_cow_block_device_matches_jax(env):
    port, jax = _readers(env)
    size = port.manifest.image_size
    got = _cow_script(CowBlockDevice(port.reader), size)
    want = _cow_script(JCow(jax.reader), size)
    assert got == want
    assert any(op[0] == "w" and op[3] > 0 for op in got)
    # the base stays immutable: a fresh reader sees the published bytes
    fresh, _ = _readers(env)
    assert fresh.reader.read(0, size) == jax.reader.read(0, size) != \
        got[-1][1]


def test_cow_sub_page_write_dirties_one_page(env):
    port, _ = _readers(env)
    dev = CowBlockDevice(port.reader)
    base = dev.read(0, 2 * PAGE)
    dev.write(10, b"z")
    assert dev.bitmap[0] and dev.dirty_bytes == PAGE
    assert dev.read(0, 2 * PAGE) == base[:10] + b"z" + base[11:]
    assert dev._overlay[0] != dev.read(0, PAGE)     # encrypted at rest


def _flat_bytes(flat: dict) -> dict:
    return {k: (np.asarray(v).dtype.str, np.asarray(v).shape,
                np.asarray(v).tobytes()) for k, v in flat.items()}


@pytest.mark.parametrize("legacy,backend", [
    ({}, "torch-fused"), ({"streamed": False}, "python"),
    ({"batched": False}, "python")])
def test_image_reader_shim_matches_jax(env, legacy, backend):
    _, tree, _ = env
    port, jax = _readers(env, backend)
    got = _flat_bytes(port.restore_tree(parallelism=2, **legacy))
    assert got == _flat_bytes(jax.restore_tree(parallelism=2, **legacy))
    assert got == _flat_bytes(tree)
    assert port.tensor_names() == jax.tensor_names()
    for name in ("w_i8", "scalar"):
        assert port.tensor(name).tobytes() == jax.tensor(name).tobytes()
    streamed = legacy.get("streamed", True)
    assert _flat_bytes(port.restore_shards(SHARDS, streamed=streamed)) == \
        _flat_bytes(jax.restore_shards(SHARDS, streamed=streamed))


def test_shim_with_serial_decoder_matches_jax(env):
    d, _, blob = env
    port = ImageReader(blob, KEY, ChunkStore(d), device="cpu",
                       decoder=BatchDecoder("serial", device="cpu"))
    jax = JReader(blob, KEY, JStore(d), decoder=JDecoder("serial"))
    assert port.reader.decoder.backend == "serial"
    assert _flat_bytes(port.restore_tree(streamed=False)) == \
        _flat_bytes(jax.restore_tree(streamed=False))


def test_shards_and_slices_match_jax(env):
    _, tree, _ = env
    port, jax = _readers(env)
    for shape, sizes in (((128, 96), [4, 1]), ((128, 96), [3, 5]),
                         ((300,), [7]), ((64, 64), [2, 2])):
        for coords in np.ndindex(*sizes):
            assert sharding_slices(shape, sizes, list(coords)) == \
                jsharding(shape, sizes, list(coords))
    w = tree["w_f32"]
    for dim_slices in ([(32, 64), (0, 96)], [(0, 128), (48, 96)],
                       sharding_slices(w.shape, [3, 2], [2, 1])):
        got = port.tensor_shard("w_f32", dim_slices)
        assert got.tobytes() == jax.tensor_shard("w_f32", dim_slices) \
            .tobytes()
        (r0, r1), (c0, c1) = dim_slices
        assert got.tobytes() == np.ascontiguousarray(w[r0:r1, c0:c1]) \
            .tobytes()
        assert port.shard_chunks({"w_f32": dim_slices}) == \
            jax.shard_chunks({"w_f32": dim_slices})
    assert port.shard_chunks(SHARDS) == jax.shard_chunks(SHARDS)


def test_read_policy_from_legacy_matches_jax():
    for kw in ({}, {"streamed": False}, {"batched": False},
               {"batched": False, "streamed": False}, {"parallelism": 3}):
        p, j = ReadPolicy.from_legacy(**kw), JPolicy.from_legacy(**kw)
        assert (p.mode, p.parallelism) == (j.mode, j.parallelism)


class CountingStore(ChunkStore):
    def __init__(self, root_dir):
        super().__init__(root_dir)
        self.gets = 0
        self._lock = threading.Lock()

    def get_chunk(self, root, name):
        with self._lock:
            self.gets += 1
        return super().get_chunk(root, name)


@pytest.mark.parametrize("mode", ["streamed", "staged"])
def test_prefetch_warms_l1_then_restore_makes_no_origin_get(env, mode):
    d, tree, blob = env
    store = CountingStore(d)
    svc = ImageService(store, ServiceConfig(device="cpu", root="R1"))
    h = svc.open(blob, KEY)
    policy = ReadPolicy(mode=mode, parallelism=2)
    shard = {"w_f32": [(0, 64), (0, 96)]}
    h.prefetch(h.shard_chunks(shard), policy)
    assert h.reader.last_batch["fetched"] == store.gets > 0
    got = h.tensor_shard("w_f32", shard["w_f32"], policy)
    assert got.tobytes() == np.ascontiguousarray(tree["w_f32"][:64]) \
        .tobytes()
    before = store.gets
    h.prefetch(list(range(h.layout.image_size // CS)), policy)
    assert store.gets > before          # the rest of the image
    before = store.gets
    flat = h.restore_tree(policy=policy)
    assert store.gets == before         # every chunk an L1 hit
    assert _flat_bytes(flat) == _flat_bytes(tree)
    assert svc.snapshot()["read.l1_hits"] > 0
    svc.close()


def test_single_image_service_builds_no_tiers(env):
    d, _, _ = env
    svc = single_image_service(ChunkStore(d), origin_delay_s=0.01,
                               device="cpu")
    assert (svc.l1, svc.l2, svc.fetch_limiter, svc.admission) == \
        (None, None, None, None)
    assert svc.config.origin_delay_s == 0.01
    svc.close()
