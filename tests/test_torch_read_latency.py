"""The read path's simulated latency (the paper's Fig. 11) in the port
against the JAX package, on the CPU: ``pipelined_latency``, the
reader's ``read_lat`` (``e2e.read``) and ``batch_lat``
(``e2e.read_batch``) recorders, and ``last_batch``'s ``sim_serial_s``
and ``sim_pipelined_s``, over one image the JAX package made.

Tolerance: the origin-only, L1-warm and serial L2 reads give the same
samples in both packages (compared sorted, as the fetch pool resolves
names in thread order; 1e-12 relative on sums, whose order follows
it). The staged and streamed L2 reads draw each node's latencies in the
order its pool threads serve it, so there they are held to the
identities that define them, not sample for sample."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import blockdev as jbd  # noqa: E402
from repro.core.blockdev import CowBlockDevice as JCow  # noqa: E402
from repro.core.loader import create_image  # noqa: E402
from repro.core.service import ImageService as JService  # noqa: E402
from repro.core.service import ReadPolicy as JPolicy  # noqa: E402
from repro.core.service import ServiceConfig as JConfig  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro_torch.core import blockdev as tbd  # noqa: E402
from repro_torch.core.blockdev import CowBlockDevice  # noqa: E402
from repro_torch.core.manifest import ZERO_CHUNK, open_manifest  # noqa: E402
from repro_torch.core.service import ImageService, ReadPolicy, \
    ServiceConfig  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402

CS = 1024
KEY = b"L" * 32
ROOT = "r0"
NO_TAIL_DEADLINE_S = 1.0       # the stripe deadline: no GET times out
SIM_KEYS = ("sim_serial_s", "sim_pipelined_s")


@pytest.mark.parametrize("seed", range(6))
def test_pipelined_latency_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lats = list(rng.exponential(0.01, int(rng.integers(1, 40))))
    for lanes in (0, 1, 3, 8, len(lats), len(lats) + 5, -2):
        assert tbd.pipelined_latency(lats, lanes) == \
            jbd.pipelined_latency(lats, lanes)
    assert tbd.pipelined_latency([], 4) == jbd.pipelined_latency([], 4) \
        == 0.0
    assert tbd.pipelined_latency(iter(lats), 2) == \
        jbd.pipelined_latency(lats, 2)
    assert (tbd.ORIGIN_LAT_S, tbd.L1_PROBE_S) == \
        (jbd.ORIGIN_LAT_S, jbd.L1_PROBE_S)


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    """An image of 12 distinct non-zero chunks made by the JAX package,
    and its distinct chunk count."""
    d = tmp_path_factory.mktemp("img")
    rng = np.random.default_rng(3)
    tree = {"emb": rng.standard_normal((24, 40)).astype(np.float32),
            "w": rng.standard_normal((7, 33)),
            "zeros": np.zeros(1500, np.float32)}
    blob, _ = create_image(tree, tenant="t", tenant_key=KEY,
                           store=JStore(d / "s"), root=ROOT, chunk_size=CS)
    names = {c.name for c in open_manifest(blob, KEY).chunks} - {ZERO_CHUNK}
    return d / "s", blob, len(names)


def _services(path, **kw):
    """(port, JAX) services over the same store with the same knobs."""
    port = ImageService(ChunkStore(path), ServiceConfig(
        device="cpu", decode_backend="python", root=ROOT, **kw))
    jax_ = JService(JStore(path), JConfig(decode_backend="python",
                                          root=ROOT, **kw))
    return port, jax_


def _restore(svc, blob, policy_cls, mode):
    h = svc.open(blob, KEY)
    h.restore_tree(policy=policy_cls(mode=mode))
    return h.reader


def _same(port_reader, jax_reader):
    pb, jb = port_reader.last_batch, jax_reader.last_batch
    for k in SIM_KEYS:
        assert pb[k] == pytest.approx(jb[k], rel=1e-12), k
    assert sorted(port_reader.read_lat.samples) == \
        sorted(jax_reader.read_lat.samples)
    assert port_reader.batch_lat.samples == \
        pytest.approx(jax_reader.batch_lat.samples, rel=1e-12)


@pytest.mark.parametrize("mode", ["staged", "streamed"])
def test_origin_then_l1_warm_restore_matches_jax(image, mode):
    path, blob, n = image
    port, jax_ = _services(path)
    readers = [_restore(s, blob, p, mode)
               for s, p in ((port, ReadPolicy), (jax_, JPolicy))]
    _same(*readers)
    lb = readers[0].last_batch
    assert lb["fetched"] == n
    # every distinct name probed the L1 once and came from the origin
    want = n * (tbd.ORIGIN_LAT_S + tbd.L1_PROBE_S)
    assert lb["sim_serial_s"] == pytest.approx(want, rel=1e-12)
    assert lb["sim_pipelined_s"] == pytest.approx(
        n * tbd.L1_PROBE_S + -(-n // 8) * tbd.ORIGIN_LAT_S, rel=1e-12)
    assert readers[0].read_lat.samples == \
        [tbd.ORIGIN_LAT_S] * n
    # the reference's gate (tests/test_batched_read.py)
    assert lb["sim_serial_s"] / lb["sim_pipelined_s"] >= 4.0
    # warm: every name an L1 hit, nothing fetched
    readers = [_restore(s, blob, p, mode)
               for s, p in ((port, ReadPolicy), (jax_, JPolicy))]
    _same(*readers)
    lb = readers[0].last_batch
    assert lb["fetched"] == 0
    assert lb["sim_serial_s"] == lb["sim_pipelined_s"] == \
        pytest.approx(n * tbd.L1_PROBE_S, rel=1e-12)
    assert readers[0].read_lat.samples[n:] == [tbd.L1_PROBE_S] * n
    assert len(readers[0].batch_lat.samples) == 2
    port.close()
    jax_.close()


def test_no_l1_restore_and_serial_reads_match_jax(image):
    """Without an L1 nothing is probed: the batch is the origin GETs
    alone. The serial path records one sample per chunk read."""
    path, blob, n = image
    port, jax_ = _services(path, l1_bytes=0)
    readers = [_restore(s, blob, p, "staged")
               for s, p in ((port, ReadPolicy), (jax_, JPolicy))]
    _same(*readers)
    assert readers[0].last_batch["sim_serial_s"] == \
        pytest.approx(n * tbd.ORIGIN_LAT_S, rel=1e-12)
    port, jax_ = _services(path)
    readers = [_restore(s, blob, p, "serial")
               for s, p in ((port, ReadPolicy), (jax_, JPolicy))]
    assert sorted(readers[0].read_lat.samples) == \
        sorted(readers[1].read_lat.samples)
    assert readers[0].last_batch == readers[1].last_batch == {}
    assert readers[0].batch_lat.samples == []


def _l2_pair(path, blob):
    """Worker A of each package fills a 12-node L2 (seed 7) through
    serial restores, so each node draws its latencies in chunk order."""
    out = []
    for svc_cls, cfg_cls, pol, kw in (
            (ImageService, ServiceConfig, ReadPolicy,
             {"device": "cpu", "decode_backend": "python"}),
            (JService, JConfig, JPolicy, {"decode_backend": "python"})):
        store = ChunkStore(path) if svc_cls is ImageService else JStore(path)
        a = svc_cls(store, cfg_cls(root=ROOT, l1_bytes=0, l2_nodes=12,
                                   l2_seed=7,
                                   l2_stripe_deadline_s=NO_TAIL_DEADLINE_S,
                                   **kw))
        _restore(a, blob, pol, "serial")
        b = svc_cls(store, cfg_cls(root=ROOT, l1_bytes=0, **kw), l2=a.l2)
        out.append((a, b, pol))
    return out


def test_l2_restores(image):
    path, blob, n = image
    (pa, pb, _), (ja, jb, _) = _l2_pair(path, blob)
    # worker A's serial fill: an L2 miss, then the origin, per chunk
    fills = [a.open(blob, KEY).reader.read_lat.samples for a in (pa, ja)]
    assert fills[0] == fills[1]
    assert len(fills[0]) == n and min(fills[0]) > tbd.ORIGIN_LAT_S
    # serial reads from the L2: the same latencies, sample for sample
    readers = [_restore(b, blob, p, "serial")
               for b, p in ((pb, ReadPolicy), (jb, JPolicy))]
    assert readers[0].read_lat.samples == readers[1].read_lat.samples
    assert len(readers[0].read_lat.samples) > 0
    assert pa.l2.fetch_lat.samples == ja.l2.fetch_lat.samples
    # every L2 read stays far under the origin's 36 ms
    assert max(readers[0].read_lat.samples) < tbd.ORIGIN_LAT_S
    for mode in ("staged", "streamed"):
        reader = _restore(pb, blob, ReadPolicy, mode)
        jreader = _restore(jb, blob, JPolicy, mode)
        lb, jlb = reader.last_batch, jreader.last_batch
        assert set(SIM_KEYS) <= set(lb) and set(SIM_KEYS) <= set(jlb)
        assert lb["fetched"] == jlb["fetched"] == lb["l2_hits"] == n
        lats = reader.read_lat.samples[-n:]
        assert lb["sim_serial_s"] == pytest.approx(sum(lats), rel=1e-12)
        # no L1: the batch is its L2 reads on 8 lanes, in landing order
        assert lb["sim_pipelined_s"] == pytest.approx(
            tbd.pipelined_latency(lats, 8), rel=1e-12)
        assert 0 < lb["sim_pipelined_s"] <= lb["sim_serial_s"] < \
            n * tbd.ORIGIN_LAT_S
        assert reader.batch_lat.samples[-1] == lb["sim_pipelined_s"]
    for svc in (pa, pb, ja, jb):
        svc.close()


@pytest.mark.parametrize("mode", ["staged", "streamed"])
def test_origin_after_an_l2_miss_adds_the_miss(image, mode):
    """A batched read through a cold L2: every chunk's latency is its
    stripe wave's miss plus the origin GET, in both packages."""
    path, blob, n = image
    for svc_cls, cfg_cls, pol, kw in (
            (ImageService, ServiceConfig, ReadPolicy,
             {"device": "cpu", "decode_backend": "python"}),
            (JService, JConfig, JPolicy, {"decode_backend": "python"})):
        store = ChunkStore(path) if svc_cls is ImageService else JStore(path)
        svc = svc_cls(store, cfg_cls(root=ROOT, l1_bytes=0, l2_nodes=12,
                                     **kw))
        reader = _restore(svc, blob, pol, mode)
        lats = reader.read_lat.samples
        assert len(lats) == n
        assert tbd.ORIGIN_LAT_S < min(lats)
        assert max(lats) <= tbd.ORIGIN_LAT_S + 0.02   # the stripe deadline
        assert reader.last_batch["sim_serial_s"] == \
            pytest.approx(sum(lats), rel=1e-12)
        svc.close()


def test_last_batch_keys_on_every_path(image):
    """``sim_*`` where the reference has them (staged and streamed
    reads, a staged prefetch), not in a streamed prefetch; an untouched
    reader's ``last_batch`` is empty."""
    path, blob, n = image
    port, jax_ = _services(path, l1_bytes=0)
    hp, hj = port.open(blob, KEY), jax_.open(blob, KEY)
    assert hp.reader.last_batch == hj.reader.last_batch == {}
    idx = list(range(len(hp.manifest.chunks)))
    for kw in ({"streamed": False}, {"streamed": True},
               {"streamed": False, "materialize": False},
               {"streamed": True, "materialize": False}):
        hp.reader.fetch_chunks(idx, **kw)
        hj.reader.fetch_chunks(idx, **kw)
        pk = set(hp.reader.last_batch)
        jk = set(hj.reader.last_batch)
        for k in SIM_KEYS:
            assert (k in pk) == (k in jk), (kw, k)
    assert len(hp.reader.batch_lat.samples) == \
        len(hj.reader.batch_lat.samples) == 3
    port.close()
    jax_.close()


def test_cow_write_records_one_batch(image):
    """A large unaligned write faults its edge pages through one
    batch: one ``batch_lat`` sample, as in the reference."""
    path, blob, _ = image
    port, jax_ = _services(path)
    devs = [CowBlockDevice(port.open(blob, KEY).reader),
            JCow(jax_.open(blob, KEY).reader)]
    counts = []
    for dev in devs:
        before = len(dev.reader.batch_lat.samples)
        dev.write(100, b"\x07" * (2 * 4096 + 200))
        counts.append(len(dev.reader.batch_lat.samples) - before)
    assert counts == [1, 1]
    port.close()
    jax_.close()
