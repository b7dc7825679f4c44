"""The port's write path (``repro_torch.core.publish``, ``core.loader``'s
``create_image``) against the JAX package's, on the CPU.

Exact, no tolerance: a port ``PublishPipeline.publish`` and the port's
serial ``create_image`` give the manifest public body, the decrypted
chunk refs and the stored ciphertexts of the JAX ``create_image`` at two
chunk sizes (sealed blobs differ only by their random nonce). A
republish skips encryption for every chunk, with ``CreateStats`` and
``publish.*`` counter deltas equal to the JAX pipeline's; the name-index
sidecar written by either package is loaded by the other; a corrupt one
starts empty; the cap trims as the JAX one does; concurrent publishers
of overlapping trees write each chunk once; ``copy_chunks`` copies what
the JAX one copies; ``ImageService.publish`` registers the image in the
GC's refcounts.

The port runs on ``device="cpu"``: the ``python`` backend (numpy AES,
hashlib), and once the ``torch-fused`` backend, whose hooks run the SHA
and AES kernels' plain PyTorch versions on the CPU. The JAX side runs
on ``numpy``."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.loader import create_image as jcreate_image  # noqa: E402
from repro.core.publish import NameIndex as JNameIndex  # noqa: E402
from repro.core.publish import PublishPipeline as JPipeline  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro.core.telemetry import COUNTERS as JCOUNTERS  # noqa: E402
from repro_torch.core.gc import GenerationalGC  # noqa: E402
from repro_torch.core.loader import create_image  # noqa: E402
from repro_torch.core.manifest import ZERO_CHUNK, open_manifest, \
    read_public  # noqa: E402
from repro_torch.core.publish import NameIndex, PublishPipeline  # noqa: E402
from repro_torch.core.service import ImageService, ServiceConfig  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.core.telemetry import COUNTERS  # noqa: E402

KEY = b"K" * 32
PUBLISH_COUNTERS = ("publish.encrypt_skipped_chunks",
                    "publish.encrypt_skipped_bytes", "publish.stage_batches",
                    "publish.chunks_uploaded", "publish.images_published",
                    "publish.name_index_saves", "store.presence_probes",
                    "store.chunks_uploaded", "store.dedup_hits")


def make_tree(seed=0, n=5, shape=(48, 256), with_zeros=True):
    rng = np.random.default_rng(seed)
    tree = {f"l{i}/w": rng.standard_normal(shape).astype(np.float32)
            for i in range(n)}
    if with_zeros:
        tree["frozen/zeros"] = np.zeros(shape, np.float32)
    return tree


def _image(store, blob, root="R1") -> tuple:
    """(public body, decrypted chunk refs, {name: stored ciphertext})."""
    m = open_manifest(blob, KEY)
    refs = [(c.index, c.name, c.key, c.sha256) for c in m.chunks]
    cts = {c.name: store.get_chunk(root, c.name) for c in m.chunks
           if c.name != ZERO_CHUNK}
    return read_public(blob), refs, cts


def _stats(st) -> tuple:
    return (st.image_id, st.total_chunks, st.zero_chunks, st.unique_chunks,
            st.dedup_chunks, st.bytes_total, st.bytes_uploaded)


@pytest.mark.parametrize("chunk_size", [2048, 8192])
def test_publish_and_create_image_match_jax(tmp_path, chunk_size):
    tree = make_tree(shape=(24, 256))
    js = JStore(tmp_path / "jax")
    jb, jst = jcreate_image(tree, tenant="t", tenant_key=KEY, store=js,
                            root="R1", chunk_size=chunk_size)
    want = _image(js, jb)
    ps = ChunkStore(tmp_path / "serial")
    pb, pst = create_image(tree, tenant="t", tenant_key=KEY, store=ps,
                           root="R1", chunk_size=chunk_size)
    assert _image(ps, pb) == want and _stats(pst) == _stats(jst)
    backends = ("python", "torch-fused") if chunk_size == 8192 \
        else ("python",)
    for backend in backends:
        bs = ChunkStore(tmp_path / backend)
        pipe = PublishPipeline(bs, backend=backend, device="cpu")
        bb, bst = pipe.publish(tree, tenant="t", tenant_key=KEY, root="R1",
                               chunk_size=chunk_size)
        pipe.close()
        assert _image(bs, bb) == want, backend
        assert _stats(bst) == _stats(jst), backend
        assert bst.unique_fraction == jst.unique_fraction
        assert bs.list_chunks("R1") == js.list_chunks("R1")
    assert jst.zero_chunks > 0              # the zero plane was elided


def _republish(pipe, store, counters):
    """First publish and an identical republish; the republish's stats,
    counter deltas and decode.forward_chunks delta."""
    tree = make_tree(seed=1)
    pipe.publish(tree, tenant="t", tenant_key=KEY, root="R1",
                 image_id="first", chunk_size=4096)
    before = counters.snapshot()
    blob, st = pipe.publish(tree, tenant="t", tenant_key=KEY, root="R1",
                            image_id="again", chunk_size=4096)
    after = counters.snapshot()
    pipe.close()
    deltas = {k: after.get(k, 0) - before.get(k, 0)
              for k in PUBLISH_COUNTERS}
    forward = after.get("decode.forward_chunks", 0) \
        - before.get("decode.forward_chunks", 0)
    return _stats(st), deltas, forward, _image(store, blob)


def test_republish_skips_encryption_like_jax(tmp_path):
    js = JStore(tmp_path / "jax")
    jout = _republish(JPipeline(js, backend="numpy"), js, JCOUNTERS)
    ps = ChunkStore(tmp_path / "port")
    pout = _republish(PublishPipeline(ps, backend="python", device="cpu"),
                      ps, COUNTERS)
    assert pout[0] == jout[0] and pout[1] == jout[1]
    assert pout[3] == jout[3]
    stats, deltas, forward, _ = pout
    nonzero = stats[1] - stats[2]
    assert stats[3] == 0 and stats[6] == 0 and stats[4] == nonzero
    assert deltas["publish.encrypt_skipped_chunks"] == nonzero
    assert forward == 0                     # not one chunk encrypted


def test_sidecar_loads_across_packages(tmp_path):
    pairs = [(bytes([i]) * 32, f"{i:064x}") for i in range(5)]
    for writer, reader in ((JNameIndex, NameIndex), (NameIndex, JNameIndex)):
        path = tmp_path / f"{writer.__module__}.idx"
        w = writer(path=path)
        w.put_many(pairs)
        w.save()
        r = reader(path=path)
        assert len(r) == 5
        assert r.get_many([k for k, _ in pairs]) == [n for _, n in pairs]
    # a restarted trainer's port pipeline skips encryption of what a JAX
    # publisher uploaded, through the JAX publisher's sidecar
    tree = make_tree(seed=2)
    path = tmp_path / "names.idx"
    store = JStore(tmp_path / "s")
    jp = JPipeline(store, backend="numpy", name_index_path=path)
    jp.publish(tree, tenant="t", tenant_key=KEY, root="R1", chunk_size=4096)
    jp.close()
    pipe = PublishPipeline(ChunkStore(tmp_path / "s"), backend="python",
                           device="cpu", name_index_path=path)
    before = COUNTERS.get("publish.encrypt_skipped_chunks")
    _, st = pipe.publish(tree, tenant="t", tenant_key=KEY, root="R1",
                         image_id="again", chunk_size=4096)
    pipe.close()
    assert COUNTERS.get("publish.encrypt_skipped_chunks") - before == \
        st.total_chunks - st.zero_chunks == st.dedup_chunks


def test_corrupt_sidecar_starts_empty(tmp_path):
    path = tmp_path / "names.idx"
    path.write_text("zz-not-hex name\n")
    out = {}
    for pkg, cls, counters in (("port", NameIndex, COUNTERS),
                               ("jax", JNameIndex, JCOUNTERS)):
        before = counters.get("publish.name_index_load_errors")
        idx = cls(path=path)
        out[pkg] = (len(idx), counters.get(
            "publish.name_index_load_errors") - before)
    assert out["port"] == out["jax"] == (0, 1)


def test_name_index_cap_trims_like_jax():
    out = {}
    for pkg, cls in (("port", NameIndex), ("jax", JNameIndex)):
        idx = cls(cap=100)
        keys = [bytes([i % 256, i // 256]) + b"k" * 30 for i in range(150)]
        idx.put_many((k, f"n{i}") for i, k in enumerate(keys))
        out[pkg] = (len(idx), idx.get_many(keys))
    assert out["port"] == out["jax"]
    assert out["port"][0] <= 100 and out["port"][1][-1] == "n149"


class SlowStore(ChunkStore):
    """PUTs take a few milliseconds (so concurrent publishers overlap)
    and are counted per name when they claim the chunk."""

    def __init__(self, path):
        super().__init__(path)
        self.claims: dict = {}
        self._lock = threading.Lock()

    def put_if_absent(self, root, name, data):
        time.sleep(0.002)
        new = super().put_if_absent(root, name, data)
        if new:
            with self._lock:
                self.claims[name] = self.claims.get(name, 0) + 1
        return new


def test_concurrent_publishers_upload_each_chunk_once(tmp_path):
    store = SlowStore(tmp_path / "s")
    pipe = PublishPipeline(store, backend="python", device="cpu",
                           upload_parallelism=4)
    a, b = make_tree(seed=4, n=6, with_zeros=False), make_tree(seed=5, n=6)
    for name in ("l0/w", "l1/w", "l2/w", "l3/w"):
        b[name] = a[name]                   # overlapping trees
    trees = [a, b, a]
    barrier = threading.Barrier(len(trees))
    out, errors = {}, []
    before = COUNTERS.snapshot()

    def publisher(i):
        try:
            barrier.wait(timeout=30)
            out[i] = pipe.publish(trees[i], tenant="t", tenant_key=KEY,
                                  root="R1", image_id=f"img-{i}",
                                  chunk_size=2048)
        except Exception as e:              # reported below
            errors.append(repr(e))
    threads = [threading.Thread(target=publisher, args=(i,))
               for i in range(len(trees))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    pipe.close()
    assert errors == []
    stored = store.list_chunks("R1")
    assert sorted(store.claims) == stored
    assert set(store.claims.values()) == {1}
    sts = [out[i][1] for i in range(len(trees))]
    assert sum(st.unique_chunks for st in sts) == len(stored)
    for st in sts:
        assert st.unique_chunks + st.dedup_chunks == \
            st.total_chunks - st.zero_chunks
    assert COUNTERS.get("publish.chunks_uploaded") \
        - before.get("publish.chunks_uploaded", 0) == len(stored)
    # every manifest equals the serial oracle's refs for its tree
    for i, tree in enumerate(trees):
        js = JStore(tmp_path / f"oracle{i}")
        jb, _ = jcreate_image(tree, tenant="t", tenant_key=KEY, store=js,
                              root="R1", image_id=f"img-{i}",
                              chunk_size=2048)
        assert _image(store, out[i][0])[:2] == _image(js, jb)[:2]


def test_copy_chunks_matches_jax(tmp_path):
    out = {}
    for pkg, store_cls, make in (
            ("port", ChunkStore,
             lambda s: PublishPipeline(s, backend="python", device="cpu")),
            ("jax", JStore, lambda s: JPipeline(s, backend="numpy"))):
        store = store_cls(tmp_path / pkg)
        store.create_root("R2")
        pipe = make(store)
        blob, _ = pipe.publish(make_tree(seed=5), tenant="t",
                               tenant_key=KEY, root="R1", chunk_size=4096)
        names = [c.name for c in open_manifest(blob, KEY).chunks]
        first = pipe.copy_chunks("R1", "R2", names + names[:3])
        again = pipe.copy_chunks("R1", "R2", names)
        pipe.close()
        copies = {n: store.get_chunk("R2", n) for n in store.list_chunks("R2")}
        out[pkg] = (first, again, copies)
        assert all(copies[n] == store.get_chunk("R1", n) for n in copies)
    assert out["port"] == out["jax"]
    assert out["port"][0] == len(out["port"][2]) > 0
    assert out["port"][1] == 0


def test_service_publish_registers_refcounts(tmp_path):
    store = ChunkStore(tmp_path / "s")
    gc = GenerationalGC(store)
    svc = ImageService(store, ServiceConfig(
        device="cpu", l2_nodes=0, max_coldstarts=0, fetch_concurrency=0,
        decode_backend="python", root=gc.active),
        pins=gc.pins, refcounts=gc.refcounts)
    tree = make_tree(seed=6)
    blob, stats = svc.publish(tree, tenant="t", tenant_key=KEY,
                              image_id="img", chunk_size=4096)
    assert gc.refcounts.live_images(gc.active) == {"img"}
    assert len(gc.refcounts.live_chunks(gc.active)) == stats.unique_chunks
    assert store.get_manifest(gc.active, "img") == blob
    flat = svc.open(blob, KEY).restore_tree()
    for name, arr in tree.items():
        assert flat[name].tobytes() == arr.tobytes()
    svc.close()
