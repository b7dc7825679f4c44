"""Images across the two packages: the port's msgpack, publish, seal and
restore against the JAX package's, byte for byte, on the CPU (where the
port's kernel backends run their plain PyTorch versions)."""
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import layout as jlayout  # noqa: E402
from repro.core import manifest as jmanifest  # noqa: E402
from repro.core.loader import create_image  # noqa: E402
from repro.core.service import ImageService as JService  # noqa: E402
from repro.core.service import ReadPolicy as JPolicy  # noqa: E402
from repro.core.service import ServiceConfig as JConfig  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro_torch.core import _msgpack  # noqa: E402
from repro_torch.core import layout as tlayout  # noqa: E402
from repro_torch.core import manifest as tmanifest  # noqa: E402
from repro_torch.core.crypto.convergent import IntegrityError  # noqa: E402
from repro_torch.core.service import ImageService, ReadPolicy, \
    ServiceConfig  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402

CS = 1024                       # small chunks keep the plain SHA cheap
KEY = b"K" * 32
ROOT = "r0"


def _tree(seed=3):
    rng = np.random.default_rng(seed)
    return {
        "emb": rng.standard_normal((20, 16)).astype(np.float32),
        "layers": [{"w": rng.standard_normal((8, 40)).astype(np.float32),
                    "b": np.zeros(300, np.float32)},
                   {"w": rng.standard_normal((3, 5)),         # float64
                    "b": np.arange(7, dtype=np.int32)}],
        "scalar": np.float32(2.5),
        "dup": np.tile(rng.standard_normal(256).astype(np.float32), 2),
    }


def _service(tmp_path, name, **kw):
    cfg = ServiceConfig(device="cpu", root=ROOT, **kw)
    return ImageService(ChunkStore(tmp_path / name), cfg)


def _chunks(store_dir):
    return {p.name: p.read_bytes()
            for p in (store_dir / "roots" / ROOT / "chunks").rglob("*")
            if p.is_file()}


def test_msgpack_matches_msgpack_on_manifest_bodies(tmp_path):
    blob, _ = create_image(_tree(), tenant="t", tenant_key=KEY,
                           store=JStore(tmp_path / "j"), root=ROOT,
                           chunk_size=CS)
    outer = msgpack.unpackb(blob, raw=False)
    body = msgpack.unpackb(outer["body"], raw=False)
    for obj in (outer, body, body["layout"], body["chunks"]):
        assert _msgpack.packb(obj) == msgpack.packb(obj, use_bin_type=True)
        assert _msgpack.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj
    assert _msgpack.unpackb(blob) == outer


def test_layout_and_chunk_stream_match_jax():
    """The port's jax-free ``canonical_paths``/``build_layout`` give the
    JAX package's layout, and both of the port's chunk writers give the
    JAX ``ImageWriter``'s chunks."""
    tree = _tree()
    jlay = jlayout.build_layout(tree, CS)
    tlay = tlayout.build_layout(tree, CS)
    assert tlay.to_table() == jlay.to_table()
    assert [n for n, _ in tlayout.canonical_paths(tree)] == \
        [n for n, _ in jlayout.canonical_paths(tree)]
    jw, tw = jlayout.ImageWriter(jlay), tlayout.ImageWriter(tlay)
    for name, leaf in jlayout.canonical_paths(tree):
        jw.put(name, leaf)
        tw.put(name, leaf)
    want = list(jw.chunks())
    assert list(tw.chunks()) == want
    assert list(tlayout.StreamingImageWriter(tlay).chunks(
        tlayout.canonical_paths(tree))) == want


def test_publish_matches_create_image_byte_for_byte(tmp_path):
    tree = _tree()
    jblob, jstats = create_image(tree, tenant="t", tenant_key=KEY,
                                 store=JStore(tmp_path / "j"), root=ROOT,
                                 salt_epoch=2, chunk_size=CS)
    svc = _service(tmp_path, "t")
    tblob, tstats = svc.publish(tree, tenant="t", tenant_key=KEY,
                                salt_epoch=2, chunk_size=CS)
    assert vars(tstats) == vars(jstats)              # image id, counts
    jm = jmanifest.open_manifest(jblob, KEY)
    tm = tmanifest.open_manifest(tblob, KEY)
    assert [(c.index, c.name, c.key, c.sha256) for c in tm.chunks] == \
        [(c.index, c.name, c.key, c.sha256) for c in jm.chunks]
    assert msgpack.packb(jm.public_body(), use_bin_type=True) == \
        _msgpack.packb(tm.public_body())
    assert _chunks(tmp_path / "t") == _chunks(tmp_path / "j")
    # the random GCM nonce is the only difference: sealed with one nonce,
    # the two packages' blobs are identical
    nonce = bytes(range(12))
    assert tmanifest.seal(tm, KEY, nonce=nonce) == \
        jmanifest.seal(jm, KEY, nonce=nonce)
    assert any(c.name == tmanifest.ZERO_CHUNK for c in tm.chunks)
    svc.close()


@pytest.mark.parametrize("backend, mode", [
    ("torch-fused", "streamed"), ("torch", "staged"), ("python", "streamed"),
    ("serial", "staged"), ("torch-fused", "serial")])
def test_jax_image_restores_through_port(tmp_path, backend, mode):
    tree = _tree()
    blob, _ = create_image(tree, tenant="t", tenant_key=KEY,
                           store=JStore(tmp_path / "s"), root=ROOT,
                           chunk_size=CS)
    svc = ImageService(ChunkStore(tmp_path / "s"),
                       ServiceConfig(device="cpu", l1_bytes=0))
    handle = svc.open(blob, KEY)
    flat = handle.restore_tree(
        policy=ReadPolicy(mode=mode, decode_backend=backend))
    want = {"emb": tree["emb"], "layers/0/w": tree["layers"][0]["w"],
            "layers/0/b": tree["layers"][0]["b"],
            "layers/1/w": tree["layers"][1]["w"],
            "layers/1/b": tree["layers"][1]["b"], "scalar": tree["scalar"],
            "dup": tree["dup"]}
    assert flat.keys() == want.keys()
    for k, v in want.items():
        assert flat[k].dtype == np.asarray(v).dtype
        assert flat[k].tobytes() == np.asarray(v).tobytes(), k
    assert handle.tensor("emb").tobytes() == tree["emb"].tobytes()
    svc.close()


@pytest.mark.parametrize("mode", ["staged", "serial"])
def test_port_image_restores_through_jax(tmp_path, mode):
    tree = _tree(5)
    svc = _service(tmp_path, "s")
    blob, _ = svc.publish(tree, tenant="t", tenant_key=KEY, chunk_size=CS)
    jsvc = JService(JStore(tmp_path / "s"), JConfig(l1_bytes=0))
    flat = jsvc.open(blob, KEY).restore_tree(policy=JPolicy(mode=mode))
    assert flat["layers/0/w"].tobytes() == tree["layers"][0]["w"].tobytes()
    assert flat["emb"].tobytes() == tree["emb"].tobytes()
    assert flat["layers/1/w"].dtype == np.float64
    jsvc.close()
    svc.close()


@pytest.mark.parametrize("mode", ["streamed", "staged"])
def test_tampered_chunk_raises_naming_it_and_leaves_l1(tmp_path, mode):
    tree = _tree()
    blob, _ = create_image(tree, tenant="t", tenant_key=KEY,
                           store=JStore(tmp_path / "s"), root=ROOT,
                           chunk_size=CS)
    m = jmanifest.open_manifest(blob, KEY)
    victim = next(c.name for c in m.chunks if c.name != jmanifest.ZERO_CHUNK)
    path = next((tmp_path / "s").rglob(victim))
    raw = bytearray(path.read_bytes())
    raw[7] ^= 0x40
    path.write_bytes(bytes(raw))
    svc = ImageService(ChunkStore(tmp_path / "s"), ServiceConfig(device="cpu"))
    with pytest.raises(IntegrityError) as ei:
        svc.open(blob, KEY).restore_tree(policy=ReadPolicy(mode=mode))
    assert ei.value.bad_positions == [victim]
    assert victim not in svc.l1
    others = [c.name for c in m.chunks
              if c.name not in (victim, jmanifest.ZERO_CHUNK)]
    assert all(n in svc.l1 for n in others)
    svc.close()
