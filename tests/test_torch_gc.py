"""The port's generational GC (``repro_torch.core.gc``) and the store's
root lifecycle against the JAX package's, on the CPU.

One scripted sequence of publish / new_root / migrate / retire_image /
sweep / expire / delete_expired / add_active_root runs through the JAX
GC and the port's, each over its own store, with the same trees. Chunk
names, every root's listings and state, the GC's stats, what each step
returned and the ``gc.*``/``store.*`` counter deltas must be equal:
exact, no tolerance (manifest blobs differ only by their random seal
nonce, so they are compared through their public bodies).

The four GC-against-live-reader races of the JAX package's
``tests/test_gc_concurrent.py`` run on the port with a gated store that
freezes a streamed restore on an origin GET; each restore must equal
the published tree byte for byte. Then: the port's sweep keeps an image
the JAX ``create_image`` wrote outside the refcount index and a
non-image blob; ``RefcountIndex`` against the JAX one; a new epoch
salts new names; ``new_root`` retires the oldest active root; a GC over
a ``FaultyStore`` reaches every store method it needs, and a read of an
expired root through it still raises the alarm.

The port runs on ``device="cpu"`` with the ``python`` backend (numpy
AES, hashlib); the JAX side on ``numpy``."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gc as jgc  # noqa: E402
from repro.core.loader import create_image as jcreate_image  # noqa: E402
from repro.core.service import ImageService as JService  # noqa: E402
from repro.core.service import ServiceConfig as JConfig  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro.core.telemetry import COUNTERS as JCOUNTERS  # noqa: E402
from repro_torch.core import gc as tgc  # noqa: E402
from repro_torch.core.faults import FaultyStore  # noqa: E402
from repro_torch.core.manifest import ZERO_CHUNK, open_manifest, \
    read_public  # noqa: E402
from repro_torch.core.service import ImageService, ReadPolicy, \
    ServiceConfig  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.core.telemetry import COUNTERS  # noqa: E402

KEY = b"G" * 32
CS = 4096
STREAMED = ReadPolicy(mode="streamed", parallelism=2)
GC_COUNTERS = ("gc.migrations", "gc.images_retired", "gc.swept_chunks",
               "gc.sweeps_deferred_pinned", "gc.deletions_blocked",
               "gc.deletions_blocked_pinned", "gc.sweep_nonimage_manifests",
               "gc.expired_read_alarms", "store.expired_root_reads",
               "store.presence_probes", "publish.migrated_chunk_copies",
               "publish.encrypt_skipped_chunks", "publish.chunks_uploaded")


def make_tree(seed=0, n=4, shape=(32, 256)):
    rng = np.random.default_rng(seed)
    return {f"l{i}/w": rng.standard_normal(shape).astype(np.float32)
            for i in range(n)}


def _port_service(store, gc, **kw):
    return ImageService(store, ServiceConfig(
        device="cpu", l1_bytes=0, l2_nodes=0, max_coldstarts=0,
        fetch_concurrency=0, decode_backend="python", publish_warm_l1=False,
        root=gc.active, **kw), pins=gc.pins, refcounts=gc.refcounts)


def _jax_service(store, gc):
    return JService(store, JConfig(
        l1_bytes=0, l2_nodes=0, max_coldstarts=0, fetch_concurrency=0,
        decode_backend="numpy", publish_warm_l1=False, root=gc.active),
        pins=gc.pins, refcounts=gc.refcounts)


PKGS = {"port": (tgc, ChunkStore, _port_service, COUNTERS),
        "jax": (jgc, JStore, _jax_service, JCOUNTERS)}


# --------------------------------------------------- scripted sequence

def _gc_script(gcmod, store_cls, make_svc, path):
    """One fixed GC sequence; returns what each step returned and the
    store's state after each step."""
    store = store_cls(path)
    gc = gcmod.GenerationalGC(store)
    svc = make_svc(store, gc)
    gc.pipeline = svc.publisher()
    a, b = make_tree(seed=1), make_tree(seed=2)
    b["l0/w"] = a["l0/w"]               # one tensor shared by both images
    c = make_tree(seed=3, n=2)
    rec = []

    def publish(tree, image_id, root):
        blob, st = svc.publish(tree, tenant="t", tenant_key=KEY, root=root,
                               salt_epoch=gc.epoch, image_id=image_id,
                               chunk_size=CS)
        rec.append(("publish", image_id, root, st.total_chunks,
                    st.zero_chunks, st.unique_chunks, st.dedup_chunks,
                    st.bytes_uploaded))

    def state(label):
        roots = store.list_roots()
        rec.append((label, roots, list(gc.active_roots), list(gc.retired),
                    list(gc.expired), gc.epoch,
                    {r: (store.root_state(r), store.list_chunks(r),
                         store.list_manifests(r)) for r in roots}))

    r1 = gc.active
    publish(a, "a", r1)
    publish(b, "b", r1)
    publish(a, "a2", r1)                # a republish dedups every chunk
    store.put_manifest(r1, "ckpt.meta", b'{"step": 3}')   # not an image
    state("published")
    r2 = gc.new_root()
    gc.migrate(r1)
    state("migrated")
    rec.append(("retire b", sorted(gc.retire_image(r2, "b"))))
    rec.append(("sweep r2", gc.sweep(r2)))
    rec.append(("sweep r1", gc.sweep(r1)))
    state("swept")
    publish(c, "c", r2)
    r3 = gc.add_active_root()
    r4 = gc.new_root()                  # retires the oldest active root
    rec.append(("roots", r1, r2, r3, r4))
    gc.expire(r1)
    rec.append(("delete r1", gc.delete_expired(r1)))
    gc.migrate(r2)
    gc.expire(r2)
    rec.append(("delete r2", gc.delete_expired(r2)))
    state("deleted")
    rec.append(("live", {r: sorted(gc.refcounts.live_images(r))
                         for r in (r1, r2, r3, r4)},
                {r: sorted(gc.refcounts.live_chunks(r))
                 for r in (r1, r2, r3, r4)}))
    st = gc.stats
    rec.append(("stats", st.migrated_manifests, st.migrated_chunks,
                st.swept_chunks, st.deleted_roots, st.alarms,
                store.deletion_frozen))
    # the migrated manifests' public bodies, from the last active root
    rec.append(("bodies", {m: read_public(store.get_manifest(r4, m))
                           for m in store.list_manifests(r4)
                           if m != "ckpt.meta"}))
    svc.close()
    return rec


def test_gc_sequence_matches_jax(tmp_path):
    out = {}
    for pkg, (gcmod, store_cls, make_svc, counters) in PKGS.items():
        before = counters.snapshot()
        rec = _gc_script(gcmod, store_cls, make_svc, tmp_path / pkg)
        after = counters.snapshot()
        out[pkg] = (rec, {k: after.get(k, 0) - before.get(k, 0)
                          for k in GC_COUNTERS})
    assert out["port"] == out["jax"]
    rec, deltas = out["port"]
    steps = {r[0]: r[1:] for r in rec}
    assert steps["delete r1"] == (True,) and steps["delete r2"] == (True,)
    assert steps["sweep r2"][0] == len(steps["retire b"][0]) > 0
    assert deltas["gc.sweep_nonimage_manifests"] >= 1
    assert deltas["publish.encrypt_skipped_chunks"] > 0
    assert deltas["gc.expired_read_alarms"] == 0


def test_either_package_reads_the_others_root_states(tmp_path):
    jstore, tstore = JStore(tmp_path), ChunkStore(tmp_path)
    jstore.create_root("R1")
    tstore.create_root("R2")
    jstore._set_state("R2", "retired")
    tstore._set_state("R1", "expired")
    for s in (jstore, tstore):
        assert (s.list_roots(), s.root_state("R1"), s.root_state("R2"),
                s.root_state("R9")) == (["R1", "R2"], "expired", "retired",
                                        "absent")


# ----------------------------------------- races with a live restore

class GatedStore(ChunkStore):
    """The first get_chunk after ``arm()`` blocks until ``release``:
    freezes a streamed restore mid-flight, deterministically."""

    def __init__(self, path):
        super().__init__(path)
        self._gate_lock = threading.Lock()
        self._arm_at = None
        self._calls = 0
        self.reached = threading.Event()
        self.release = threading.Event()

    def arm(self):
        with self._gate_lock:
            self._arm_at = self._calls + 1
        self.reached.clear()
        self.release.clear()

    def get_chunk(self, root, name):
        with self._gate_lock:
            self._calls += 1
            hit = self._arm_at is not None and self._calls == self._arm_at
        if hit:
            self.reached.set()
            assert self.release.wait(timeout=30), "gate never released"
        return super().get_chunk(root, name)


def fixture(tmp_path):
    """(store, gc, svc) with pins and refcounts wired and no caches, so
    every read reaches the (gateable) origin."""
    store = GatedStore(tmp_path / "store")
    gc = tgc.GenerationalGC(store)
    svc = _port_service(store, gc)
    gc.pipeline = svc.publisher()
    return store, gc, svc


def frozen_restore(svc, store, blob, root):
    """A streamed restore on a thread, blocked on its next origin GET.
    Returns (thread, result dict with 'tree' set on completion)."""
    result = {}

    def run():
        result["tree"] = svc.open(blob, KEY, root=root).restore_tree(
            policy=STREAMED)

    store.arm()
    t = threading.Thread(target=run)
    t.start()
    assert store.reached.wait(timeout=30), "restore never hit origin"
    return t, result


def finish(store, t, result, tree):
    store.release.set()
    t.join(timeout=60)
    assert not t.is_alive()
    for name, arr in tree.items():
        assert result["tree"][name].tobytes() == arr.tobytes(), name


def _publish(svc, tree, image_id):
    return svc.publish(tree, tenant="t", tenant_key=KEY, image_id=image_id,
                       chunk_size=CS)


def test_new_root_and_migrate_mid_restore_byte_identical(tmp_path):
    store, gc, svc = fixture(tmp_path)
    tree = make_tree(seed=1)
    old = gc.active
    blob, _ = _publish(svc, tree, "img")
    t, result = frozen_restore(svc, store, blob, old)
    assert gc.pins.pinned(old)
    gc.new_root()                    # the generation rolls under the reader
    gc.migrate(old)
    finish(store, t, result, tree)
    assert not gc.pins.pinned(old)
    blob2 = store.get_manifest(gc.active, "img")
    flat = svc.open(blob2, KEY, root=gc.active).restore_tree()
    for name, arr in tree.items():
        assert flat[name].tobytes() == arr.tobytes()
    svc.close()


def test_expire_and_delete_refused_while_pinned(tmp_path):
    store, gc, svc = fixture(tmp_path)
    tree = make_tree(seed=2)
    old = gc.active
    blob, _ = _publish(svc, tree, "img")
    t, result = frozen_restore(svc, store, blob, old)
    gc.new_root()
    gc.migrate(old)
    gc.expire(old)                   # races the still-pinned reader
    before = COUNTERS.get("gc.deletions_blocked_pinned")
    assert gc.delete_expired(old) is False
    assert COUNTERS.get("gc.deletions_blocked_pinned") == before + 1
    # the reader resumes into an expired root: it still gets its bytes,
    # but its reads raise the alarm and freeze every later deletion
    finish(store, t, result, tree)
    assert gc.stats.alarms and store.deletion_frozen
    assert gc.delete_expired(old) is False
    with pytest.raises(RuntimeError, match="frozen"):
        store.delete_chunk(old, "x")
    svc.close()


def test_drained_root_deletes_cleanly(tmp_path):
    store, gc, svc = fixture(tmp_path)
    tree = make_tree(seed=3)
    old = gc.active
    blob, _ = _publish(svc, tree, "img")
    t, result = frozen_restore(svc, store, blob, old)
    gc.new_root()
    gc.migrate(old)
    finish(store, t, result, tree)   # drain BEFORE expiring: no alarm
    gc.expire(old)
    assert gc.delete_expired(old) is True
    assert gc.stats.alarms == [] and not store.deletion_frozen
    assert old not in store.list_roots()
    svc.close()


def test_sweep_deferred_while_pinned_then_reclaims(tmp_path):
    store, gc, svc = fixture(tmp_path)
    root = gc.active
    keep, drop = make_tree(seed=4), make_tree(seed=5)
    blob_keep, _ = _publish(svc, keep, "keep")
    _, st_drop = _publish(svc, drop, "drop")
    dead = gc.retire_image(root, "drop")
    assert len(dead) == st_drop.unique_chunks
    t, result = frozen_restore(svc, store, blob_keep, root)
    before = COUNTERS.get("gc.sweeps_deferred_pinned")
    assert gc.sweep(root) == 0       # deferred: the reader pins the root
    assert COUNTERS.get("gc.sweeps_deferred_pinned") == before + 1
    assert all(store.has_chunk(root, n) for n in dead)
    finish(store, t, result, keep)
    assert gc.sweep(root) == len(dead)
    assert not any(store.has_chunk(root, n) for n in dead)
    flat = svc.open(blob_keep, KEY, root=root).restore_tree()
    for name, arr in keep.items():
        assert flat[name].tobytes() == arr.tobytes()
    svc.close()


# ------------------------------------------------------ safety floors

def test_sweep_keeps_unindexed_jax_image_and_non_image_blob(tmp_path):
    store = ChunkStore(tmp_path)
    gc = tgc.GenerationalGC(store)
    root = gc.active
    blob, _ = jcreate_image(make_tree(seed=6), tenant="legacy",
                            tenant_key=KEY, store=JStore(tmp_path),
                            root=root, chunk_size=CS, image_id="legacy")
    store.put_manifest(root, "ckpt-7.meta", b'{"step": 7}')
    assert "legacy" not in gc.refcounts.live_images(root)
    chunks = store.list_chunks(root)
    before = COUNTERS.get("gc.sweep_nonimage_manifests")
    assert gc.sweep(root) == 0
    assert COUNTERS.get("gc.sweep_nonimage_manifests") == before + 1
    assert store.list_chunks(root) == chunks
    assert store.list_manifests(root) == ["ckpt-7.meta", "legacy"]
    for c in open_manifest(blob, KEY).chunks:
        if c.name != ZERO_CHUNK:
            assert store.has_chunk(root, c.name)


def test_refcount_index_matches_jax():
    out = {}
    for pkg, mod in (("port", tgc), ("jax", jgc)):
        idx = mod.RefcountIndex()
        idx.add_image("R1", "a", ["c1", "c2", "c3"])
        idx.add_image("R1", "b", ["c2", "c3", "c4"])
        idx.add_image("R1", "a", ["c1"])        # idempotent republish
        idx.add_image("R2", "a", ["c1"])
        rec = [idx.refcount("R1", "c2"), sorted(idx.live_images("R1")),
               sorted(idx.image_chunks("R1", "b"))]
        rec.append(sorted(idx.remove_image("R1", "a")))
        rec.append(sorted(idx.live_chunks("R1")))
        rec.append(sorted(idx.remove_image("R1", "a")))   # double retire
        rec.append(sorted(idx.remove_image("R1", "b")))
        rec.append((sorted(idx.live_images("R1")),
                    sorted(idx.live_chunks("R2")), idx.refcount("R9", "x")))
        out[pkg] = rec
    assert out["port"] == out["jax"]
    assert out["port"][3] == ["c1"]             # c2, c3 still held by b


def test_new_epoch_salts_new_names(tmp_path):
    store = ChunkStore(tmp_path)
    gc = tgc.GenerationalGC(store)
    svc = _port_service(store, gc)
    gc.pipeline = svc.publisher()
    tree = make_tree(seed=7)
    names = []
    for image_id in ("e0", "e1"):
        blob, _ = svc.publish(tree, tenant="t", tenant_key=KEY,
                              root=gc.active, salt_epoch=gc.epoch,
                              image_id=image_id, chunk_size=CS)
        names.append({c.name for c in open_manifest(blob, KEY).chunks
                      if c.name != ZERO_CHUNK})
        gc.new_root()
    assert names[0] and names[1] and names[0].isdisjoint(names[1])
    svc.close()


def test_new_root_retires_the_oldest_active_root(tmp_path):
    out = {}
    for pkg, (gcmod, store_cls, _, _) in PKGS.items():
        store = store_cls(tmp_path / pkg)
        gc = gcmod.GenerationalGC(store)
        staged = [gc.add_active_root(), gc.add_active_root()]
        rolled = gc.new_root()
        out[pkg] = (staged, rolled, list(gc.active_roots), list(gc.retired),
                    gc.epoch, {r: store.root_state(r)
                               for r in store.list_roots()})
    assert out["port"] == out["jax"]
    assert out["port"][3] == ["R1"]
    assert out["port"][2] == ["R2", "R3", "R4"]


def test_gc_over_faulty_store_reaches_the_store(tmp_path):
    inner = ChunkStore(tmp_path)
    store = FaultyStore(inner)
    gc = tgc.GenerationalGC(store)
    svc = _port_service(store, gc)
    gc.pipeline = svc.publisher()
    tree = make_tree(seed=8, n=2)
    blob, st = _publish(svc, tree, "img")
    old = gc.active
    gc.new_root()
    gc.migrate(old)
    assert store.list_roots() == inner.list_roots() == ["R1", "R2"]
    assert store.list_chunks(gc.active) == inner.list_chunks(old)
    assert store.has_chunks(gc.active, store.list_chunks(old)) == \
        set(inner.list_chunks(old))
    gc.expire(old)
    assert store.root_state(old) == "expired"
    name = inner.list_chunks(old)[0]
    store.get_chunk(old, name)           # FaultyStore's own get_chunk
    assert gc.stats.alarms == [old] and inner.deletion_frozen
    assert gc.delete_expired(old) is False
    svc.close()
