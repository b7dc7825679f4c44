"""The port's L2 tier against the JAX package's, on the CPU: hash-ring
placement, the erasure-coded ``DistributedCache`` healthy and under
faults, salting, and restores through an ``ImageService`` whose L2 a
first worker filled and in which one node has crashed. Tolerance: exact
bytes and the same hit/miss pattern.

The simulated stripe latency has a heavy tail that, about once in
several thousand GETs, passes the default 20 ms stripe deadline. Where a
check needs every GET to answer (one node crashed, and the chunks must
still be hits), the caches here take a 1 s deadline, which the latency
model never reaches; a blackholed node still times out."""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.cache import distributed as jdist  # noqa: E402
from repro.core.cache.hashring import HashRing as JRing  # noqa: E402
from repro.core.loader import create_image  # noqa: E402
from repro.core.service import ImageService as JService  # noqa: E402
from repro.core.service import ReadPolicy as JPolicy  # noqa: E402
from repro.core.service import ServiceConfig as JConfig  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro.core.telemetry import COUNTERS as JCOUNTERS  # noqa: E402
from repro_torch.core.cache import distributed as tdist  # noqa: E402
from repro_torch.core.cache.hashring import HashRing  # noqa: E402
from repro_torch.core.crypto.convergent import IntegrityError  # noqa: E402
from repro_torch.core.manifest import ZERO_CHUNK, open_manifest  # noqa: E402
from repro_torch.core.service import ImageService, ReadPolicy, \
    ServiceConfig  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.core.telemetry import COUNTERS  # noqa: E402
from repro_torch.kernels.gf256.ops import rs_matmul_fn  # noqa: E402
from repro_torch.kernels.parity.ops import parity_fn_for_erasure  # noqa: E402

CS = 1024
KEY = b"K" * 32
ROOT = "r0"
NO_TAIL_DEADLINE_S = 1.0
L2_COUNTERS = ("l2.hits", "l2.misses", "l2.stripe_timeouts")


def _tree(seed=4):
    rng = np.random.default_rng(seed)
    return {"emb": rng.standard_normal((24, 40)).astype(np.float32),
            "w": rng.standard_normal((7, 33)),
            "zeros": np.zeros(1500, np.float32)}


def test_hash_ring_lookup_matches_jax():
    nodes = [f"cache-{i:03d}" for i in range(12)]
    ring, jring = HashRing(nodes, vnodes=64), JRing(nodes, vnodes=64)
    for i in range(1000):
        key = f"chunk-{i:04d}/s{i % 5}"
        assert ring.lookup(key, count=5) == jring.lookup(key, count=5)
        assert ring.lookup(key) == jring.lookup(key)
    small = [f"n{i}" for i in range(3)]
    assert HashRing(small).lookup("x", count=5) == \
        JRing(small).lookup("x", count=5)


def _caches(**kw):
    """The port's L2 (CPU kernel hooks) and the JAX one (numpy), same
    seed and nodes."""
    port = tdist.DistributedCache(
        num_nodes=12, seed=7, parity_fn=parity_fn_for_erasure("cpu"),
        matmul_fn=rs_matmul_fn("cpu"), **kw)
    return port, jdist.DistributedCache(num_nodes=12, seed=7, **kw)


def _snap(counters):
    return {k: counters.get(k) for k in L2_COUNTERS}


@pytest.mark.parametrize("fault", ["healthy", "crashed", "blackholed",
                                   "slow"])
def test_distributed_cache_matches_jax(fault):
    rng = np.random.default_rng(11)
    port, jax_ = _caches(stripe_deadline_s=NO_TAIL_DEADLINE_S)
    datas = {f"c{i:02d}": rng.integers(0, 256, 1000, np.uint8).tobytes()
             for i in range(30)}
    for name, data in datas.items():
        port.put_chunk(name, data)
        jax_.put_chunk(name, data)
    victim = "cache-003"
    port.set_fault(victim, getattr(tdist.FaultPlan, fault)())
    jax_.set_fault(victim, getattr(jdist.FaultPlan, fault)())
    names = list(datas) + ["absent-0", "absent-1"]
    hedge = True if fault == "slow" else None
    before = (_snap(COUNTERS), _snap(JCOUNTERS))
    results = []
    for cache in (port, jax_):
        batched = cache.get_chunks(names, 1000, hedge=hedge)
        streamed = {}
        cache.get_chunks(names, 1000, hedge=hedge,
                         on_ready=lambda n, lat, d: streamed.setdefault(n, d))
        serial = {n: cache.get_chunk(n, 1000)[1] for n in names}
        results.append(({n: batched[n][1] for n in names}, streamed, serial))
    deltas = [{k: c.get(k) - b[k] for k in L2_COUNTERS}
              for c, b in zip((COUNTERS, JCOUNTERS), before)]
    assert results[0] == results[1]
    batched, streamed, serial = results[0]
    assert batched == serial
    assert streamed == {n: d for n, d in batched.items() if d is not None}
    assert any(victim in port.ring.lookup(n, count=5) for n in datas)
    want = dict(datas, **{"absent-0": None, "absent-1": None})
    assert batched == want
    assert deltas[0] == deltas[1]
    assert deltas[0]["l2.hits"] == 3 * len(datas)
    assert deltas[0]["l2.misses"] == 3 * 2
    # a blackholed node times out every GET it is sent, three reads each
    on_victim = sum(victim in port.ring.lookup(n, count=5) for n in names)
    assert deltas[0]["l2.stripe_timeouts"] == \
        (3 * on_victim if fault == "blackholed" else 0)


def test_concurrent_fills_and_reads_keep_every_chunk():
    """The origin stage fills the L2 from every fetch thread at once:
    with more threads than cores and a short switch interval, every
    chunk written is read back whole, one by one and in one batch."""
    rng = np.random.default_rng(5)
    cache = tdist.DistributedCache(
        num_nodes=12, seed=5, parity_fn=parity_fn_for_erasure("cpu"),
        matmul_fn=rs_matmul_fn("cpu"), stripe_deadline_s=NO_TAIL_DEADLINE_S)
    datas = {f"c{i:03d}": rng.integers(0, 256, 700, np.uint8).tobytes()
             for i in range(96)}
    names = list(datas)
    errors = []

    def worker(mine):
        try:
            for n in mine:
                cache.put_chunk(n, datas[n])
                if cache.get_chunk(n, 700)[1] != datas[n]:
                    errors.append(n)
        except Exception as e:       # reported by the assertion below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(names[i::16],))
               for i in range(16)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    got = cache.get_chunks(names, 700)
    assert {n: v[1] for n, v in got.items()} == datas


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_invalidate_drops_every_salt(pkg):
    """A chunk read past the infection threshold is salted into three
    placement keys; ``invalidate`` drops the stripes of all three, in
    the port as in the reference."""
    mod = tdist if pkg == "port" else jdist
    cache = mod.DistributedCache(num_nodes=12, seed=3, infection_threshold=2,
                                 salt_count=3,
                                 stripe_deadline_s=NO_TAIL_DEADLINE_S)
    data = bytes(range(256)) * 8
    cache.put_chunk("hot", data)
    for _ in range(3):
        assert cache.get_chunk("hot", len(data))[1] == data
    assert cache._salts["hot"] == 3

    def stored():
        return sorted(k for node in cache.nodes.values()
                      for k in list(node.mem.data) + list(node.flash.data)
                      if k.startswith("hot"))
    keys = stored()
    assert {k.split("/")[0] for k in keys} == {"hot", "hot#s1", "hot#s2"}
    cache.invalidate("hot")
    assert stored() == []
    assert "hot" not in cache._salts
    assert cache.get_chunk("hot", len(data))[1] is None


@pytest.fixture
def image(tmp_path):
    """An image made by the JAX package, its ``serial``-backend restore
    (the reference bytes), and the distinct chunk names."""
    tree = _tree()
    blob, _ = create_image(tree, tenant="t", tenant_key=KEY,
                           store=JStore(tmp_path / "s"), root=ROOT,
                           chunk_size=CS)
    jsvc = JService(JStore(tmp_path / "s"), JConfig(l1_bytes=0))
    ref = jsvc.open(blob, KEY).restore_tree(
        policy=JPolicy(mode="staged", decode_backend="serial"))
    jsvc.close()
    names = {c.name for c in open_manifest(blob, KEY).chunks} - {ZERO_CHUNK}
    return ChunkStore(tmp_path / "s"), blob, ref, names


def _filled_l2(store, blob, names):
    """Worker A restores with an empty L1 and a 6-node L2: every chunk
    comes from the origin, and each origin GET fills the L2 once."""
    a = ImageService(store, ServiceConfig(
        device="cpu", root=ROOT, l2_nodes=6,
        l2_stripe_deadline_s=NO_TAIL_DEADLINE_S))
    h = a.open(blob, KEY)
    before = h.counters.get("read.origin_fetches")
    h.restore_tree()
    assert h.counters.get("read.origin_fetches") - before == len(names)
    assert h.reader.last_batch["l2_hits"] == 0
    return a


def test_worker_restores_from_l2_with_a_crashed_node(image):
    store, blob, ref, names = image
    a = _filled_l2(store, blob, names)
    a.l2.set_fault("cache-000", tdist.FaultPlan.crashed())
    calls = []
    matmul = a.l2.coder.matmul_fn
    a.l2.coder.matmul_fn = lambda m, d: calls.append(d.shape) or matmul(m, d)
    b = ImageService(store, ServiceConfig(device="cpu", root=ROOT,
                                          l1_bytes=0), l2=a.l2)
    h = b.open(blob, KEY)
    for mode in ("staged", "streamed", "serial"):
        before = h.counters.get("read.origin_fetches")
        flat = h.restore_tree(policy=ReadPolicy(mode=mode))
        assert flat.keys() == ref.keys()
        for k in ref:
            assert flat[k].tobytes() == ref[k].tobytes(), (mode, k)
        assert h.counters.get("read.origin_fetches") == before, mode
        if mode != "serial":
            assert h.reader.last_batch["l2_hits"] == len(names)
        if mode == "staged":
            # the GF(256) hook rebuilt the chunks that lost a data
            # stripe or drew the parity stripe among the k fastest
            assert calls
    b.close()
    a.close()


@pytest.mark.parametrize("mode", ["staged", "streamed"])
def test_tampered_l2_stripe_raises_naming_it_and_is_evicted(image, mode):
    store, blob, ref, names = image
    a = _filled_l2(store, blob, names)
    l2 = a.l2
    victim = sorted(names)[0]
    nodes = l2.ring.lookup(victim, count=l2.coder.n)
    key = f"{victim}/s0"
    bad = bytearray(l2.nodes[nodes[0]].flash.data[key])
    bad[3] ^= 0x10
    l2.nodes[nodes[0]].mem.put(key, bytes(bad))
    l2.nodes[nodes[0]].flash.put(key, bytes(bad))
    # with the parity stripe's node down, stripes 0-3 rebuild the chunk
    l2.set_fault(nodes[4], tdist.FaultPlan.crashed())
    b = ImageService(store, ServiceConfig(device="cpu", root=ROOT,
                                          l1_bytes=0), l2=l2)
    h = b.open(blob, KEY)
    with pytest.raises(IntegrityError) as ei:
        h.restore_tree(policy=ReadPolicy(mode=mode))
    assert ei.value.bad_positions == [victim]
    for i, node in enumerate(nodes):
        sk = f"{victim}/s{i}"
        assert sk not in l2.nodes[node].mem and sk not in l2.nodes[node].flash
    before = h.counters.get("read.origin_fetches")
    flat = h.restore_tree(policy=ReadPolicy(mode=mode))
    assert all(flat[k].tobytes() == ref[k].tobytes() for k in ref)
    assert h.counters.get("read.origin_fetches") == before + 1
    b.close()
    a.close()
