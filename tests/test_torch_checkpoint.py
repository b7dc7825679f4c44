"""The port's checkpoint layer (``repro_torch.train.checkpoint``, the
trainer's ``resume``) on the CPU, against the JAX package's.

* Checkpoints cross between the packages both ways, for float32 and
  bfloat16 Adam moments: a JAX ``Trainer``'s step-2 checkpoint resumes in
  the port's ``Trainer`` byte for byte (every leaf's dtype string, shape
  and bytes); the port trains on to step 4 and checkpoints through an
  ``ImageService``; the JAX ``Trainer`` resumes that byte for byte; then
  one more step in each package gives losses within 1e-5 (float32 on
  both sides, the same weights and batch) and the port's loss is finite.
* The JAX package's own checkpoint cases on the port
  (``tests/test_checkpoint_elastic.py``): bitwise resume (here the
  resumed losses must equal the uninterrupted ones exactly), frozen-subset
  dedup, async upload overlap, selected-tensor restore; and an upload
  failure re-raised as ``CheckpointUploadError`` on the next ``wait``.
* ``retire_before`` returns exactly the chunks only older checkpoints
  held, the sweep reclaims them, ``discover`` rebuilds the records.
* A tree with bfloat16 leaves (a torch tensor and a JAX array) publishes
  to the JAX ``create_image``'s manifest (public body, decrypted chunk
  refs, ciphertexts: sealed blobs differ only by their random nonce)
  and reads back as torch bfloat16 tensors with the same bits.

The port's service runs the ``python`` backend (host AES and hashlib),
its serial reader the ``torch-fused`` plain versions; all exact but the
one loss comparison (both trainers compute in float32 there)."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.gc import GenerationalGC as JGC  # noqa: E402
from repro.core.loader import create_image as jcreate_image  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro.models.lm import RunFlags as JFlags  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.train.checkpoint import state_to_tree as jax_tree  # noqa: E402
from repro.train.loop import LoopConfig as JLoop  # noqa: E402
from repro.train.loop import Trainer as JTrainer  # noqa: E402
from repro.train.optimizer import OptConfig as JOpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.gc import GenerationalGC  # noqa: E402
from repro_torch.core.layout import leaf_array, leaf_dtype  # noqa: E402
from repro_torch.core.loader import create_image  # noqa: E402
from repro_torch.core.manifest import ZERO_CHUNK, open_manifest, \
    read_public  # noqa: E402
from repro_torch.core.service import ImageService, ServiceConfig  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.core.telemetry import COUNTERS  # noqa: E402
from repro_torch.models.lm import RunFlags  # noqa: E402
from repro_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager,
    CheckpointUploadError,
    state_to_tree,
)
from repro_torch.train.loop import LoopConfig, Trainer  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

KEY = b"C" * 32
CHUNK = 16384


def _service(store, gc):
    return ImageService(store, ServiceConfig(device="cpu",
                                             decode_backend="python"),
                        pins=gc.pins, refcounts=gc.refcounts)


def _manager(store, gc, service=True, **kw):
    return CheckpointManager(store, gc, tenant="train", tenant_key=KEY,
                             chunk_size=CHUNK, device="cpu",
                             service=_service(store, gc) if service else None,
                             **kw)


def _same_bytes(port_flat: dict, jax_flat: dict):
    assert port_flat.keys() == jax_flat.keys()
    for name, leaf in port_flat.items():
        want = np.asarray(jax_flat[name])
        assert leaf_dtype(leaf) == str(want.dtype), name
        got = leaf_array(leaf)
        assert got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(tmp_path, moments):
    loop = dict(steps=2, batch=2, seq=16, ckpt_every=2, log_every=1)
    jtr = JTrainer(jax_config("smollm-360m").reduced(),
                   JLoop(**loop, opt=JOpt(moments=moments)),
                   ckpt_mgr=JManager(JStore(tmp_path), JGC(JStore(tmp_path)),
                                     tenant="train", tenant_key=KEY,
                                     chunk_size=CHUNK),
                   flags=JFlags(dtype="float32")).init()
    jtr.run()
    store = ChunkStore(tmp_path)
    gc = GenerationalGC(store)
    ptr = Trainer(get_config("smollm-360m").reduced(),
                  LoopConfig(**loop, opt=OptConfig(moments=moments)),
                  ckpt_mgr=_manager(store, gc),
                  flags=RunFlags(dtype="float32"), device="cpu").resume()
    assert ptr.step == 2
    _same_bytes(state_to_tree(ptr.state), jax_tree(jtr.state))
    if moments == "bfloat16":
        assert ptr.state["opt"]["m"]["embed"].dtype == torch.bfloat16

    ptr.run(2)                                   # publishes step 4
    assert [r.step for r in ptr.ckpt.records] == [4]
    jtr.resume()
    assert jtr.step == 4
    _same_bytes(state_to_tree(ptr.state), jax_tree(jtr.state))
    jtr.run(1)
    ptr.run(1)
    assert np.isfinite(ptr.history[-1]["loss"])
    assert abs(ptr.history[-1]["loss"] - jtr.history[-1]["loss"]) <= 1e-5


def test_bitwise_resume(tmp_path):
    cfg = get_config("smollm-360m").reduced()
    lc = LoopConfig(steps=8, batch=2, seq=16, ckpt_every=4, log_every=1)
    store = ChunkStore(tmp_path)
    gc = GenerationalGC(store)
    tr = Trainer(cfg, lc, ckpt_mgr=_manager(store, gc, service=False),
                 device="cpu").init()
    tr.run(4)                      # checkpoint lands at step 4
    tr.ckpt.wait()
    ref_state = state_to_tree(tr.state)
    tr.run(2)                      # advance past the checkpoint

    tr2 = Trainer(cfg, lc, ckpt_mgr=_manager(store, gc, service=False),
                  device="cpu").resume()
    assert tr2.step == 4
    got = state_to_tree(tr2.state)
    assert got.keys() == ref_state.keys()
    for k in got:
        assert leaf_array(got[k]).tobytes() == \
            leaf_array(ref_state[k]).tobytes(), k
    h2 = tr2.run(2)
    assert [h["loss"] for h in h2] == [h["loss"] for h in tr.history[4:6]]


def test_incremental_dedup_frozen_subset(tmp_path):
    """Frozen tensors re-upload ZERO chunks across checkpoints."""
    store = ChunkStore(tmp_path)
    ck = _manager(store, GenerationalGC(store), async_upload=False)
    rng = np.random.default_rng(0)
    frozen = rng.standard_normal((256, 256)).astype(np.float32)
    ck.save(1, {"frozen/w": torch.from_numpy(frozen),
                "hot/w": rng.standard_normal((64, 64)).astype(np.float32)})
    ck.save(2, {"frozen/w": frozen,
                "hot/w": rng.standard_normal((64, 64)).astype(np.float32)})
    ck.wait()
    s1, s2 = ck.records[0].stats, ck.records[1].stats
    assert s2["dedup_chunks"] >= 16     # the frozen tensor's chunks
    assert s2["bytes_uploaded"] < s1["bytes_uploaded"] / 2
    assert COUNTERS.get("ckpt.saves") >= 2


def test_async_upload_overlaps(tmp_path):
    store = ChunkStore(tmp_path)
    ck = _manager(store, GenerationalGC(store), service=False)
    gen = torch.Generator().manual_seed(1)
    big = {"w": torch.randn(512, 512, generator=gen)}
    t0 = time.time()
    ck.save(1, big)
    t_submit = time.time() - t0
    ck.wait()
    assert ck.records and ck.records[0].step == 1
    # submission returns before upload completes (thread did the work)
    assert t_submit < ck.records[0].stats["seconds"] + 0.5


def test_restore_selected_tensors(tmp_path):
    store = ChunkStore(tmp_path)
    ck = _manager(store, GenerationalGC(store), async_upload=False)
    tree = {"a": np.arange(10, dtype=np.float32),
            "b": torch.arange(20, dtype=torch.bfloat16)}
    ck.save(3, tree)
    got = ck.restore_tensors(ck.records[-1], ["b"])
    assert got.keys() == {"b"}
    assert torch.equal(got["b"], tree["b"])


class _FailingStore:
    """A store whose chunk PUTs fail."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, item):
        return getattr(self.inner, item)

    def put_if_absent(self, root, name, data):
        raise OSError("disk full")


def test_upload_failure_reraised_on_next_wait(tmp_path):
    store = _FailingStore(ChunkStore(tmp_path))
    ck = _manager(store, GenerationalGC(store), service=False)
    before = COUNTERS.get("ckpt.upload_failures")
    ck.save(1, {"w": np.ones((64, 64), np.float32)})
    with pytest.raises(CheckpointUploadError) as err:
        ck.wait()
    assert isinstance(err.value.__cause__, OSError)
    assert COUNTERS.get("ckpt.upload_failures") == before + 1
    assert ck.records == []
    ck.wait()                      # raised once, then clear


def test_retire_before_and_discover(tmp_path):
    store = ChunkStore(tmp_path)
    gc = GenerationalGC(store)
    ck = _manager(store, gc, async_upload=False, run_name="r")
    rng = np.random.default_rng(4)
    shared = rng.standard_normal((128, 128)).astype(np.float32)
    trees = [{"shared": shared,
              "own": rng.standard_normal((128, 128)).astype(np.float32)}
             for _ in range(3)]
    for step, tree in enumerate(trees, start=1):
        ck.save(step, tree)
    found = _manager(store, gc, run_name="r").discover()
    assert [(r.step, r.image_id, r.root) for r in found] == \
        [(r.step, r.image_id, r.root) for r in ck.records]

    def names(rec):
        m = open_manifest(store.get_manifest(rec.root, rec.image_id), KEY)
        return {c.name for c in m.chunks} - {ZERO_CHUNK}

    old, newest = ck.records[:-1], ck.records[-1]
    want = set().union(*(names(r) for r in old)) - names(newest)
    dead = ck.retire_before(keep_last=1)
    assert dead == want and len(dead) == 2 * 4   # two "own" tensors
    assert [r.step for r in ck.records] == [3]
    assert [r.step for r in ck.discover()] == [3]
    assert not store.has_manifest(gc.active, f"{old[0].image_id}.meta")
    assert gc.sweep(gc.active) == len(dead)
    assert set(store.list_chunks(gc.active)) == names(newest)
    flat = ck.reader(newest).restore_tree()
    assert np.array_equal(flat["own"], trees[2]["own"])


def _image(store, blob, root="R1") -> tuple:
    m = open_manifest(blob, KEY)
    refs = [(c.index, c.name, c.key, c.sha256) for c in m.chunks]
    cts = {c.name: store.get_chunk(root, c.name) for c in m.chunks
           if c.name != ZERO_CHUNK}
    return read_public(blob), refs, cts


def test_bfloat16_tree_matches_jax_create_image(tmp_path):
    rng = np.random.default_rng(5)
    m = rng.standard_normal((40, 100)).astype(np.float32)
    v = rng.standard_normal((3, 7)).astype(np.float32)
    jax_tree_ = {"opt/m": np.asarray(jnp.asarray(m, jnp.bfloat16)),
                 "opt/v": np.asarray(jnp.asarray(v, jnp.bfloat16)),
                 "w": m, "step": np.array(3, np.int32)}
    port_tree = {"opt/m": torch.from_numpy(m).to(torch.bfloat16),
                 "opt/v": jax_tree_["opt/v"],       # the JAX array as is
                 "w": torch.from_numpy(m), "step": np.array(3, np.int32)}
    js = JStore(tmp_path / "jax")
    jb, jst = jcreate_image(jax_tree_, tenant="t", tenant_key=KEY, store=js,
                            root="R1", chunk_size=2048)
    want = _image(js, jb)
    ps = ChunkStore(tmp_path / "port")
    pb, pst = create_image(port_tree, tenant="t", tenant_key=KEY, store=ps,
                           root="R1", chunk_size=2048)
    assert _image(ps, pb) == want
    assert pst.image_id == jst.image_id
    ss = ChunkStore(tmp_path / "svc")
    svc = ImageService(ss, ServiceConfig(device="cpu", decode_backend="python",
                                         root="R1"))
    sb, _ = svc.publish(port_tree, tenant="t", tenant_key=KEY,
                        chunk_size=2048)
    assert _image(ss, sb) == want
    layout = open_manifest(sb, KEY).layout_table
    assert {row[0]: row[3] for row in layout}["opt/m"] == "bfloat16"
    got = svc.open(sb, KEY).restore_tree()
    for name in ("opt/m", "opt/v"):
        assert got[name].dtype == torch.bfloat16
        assert leaf_array(got[name]).tobytes() == \
            jax_tree_[name].tobytes()
    svc.close()
