"""The L2's measurement and control surface in the port against the JAX
package, on the CPU (a port of ``tests/test_cache.py``'s L2 cases):
the hash ring's bounded loads, the hot-key tracker's window, the 4-of-4
read of the paper's Fig. 9 beside the 4-of-5 read, ``fail_node``,
``flush``, ``hit_rate``, ``CacheNode.failed``, the ``l2.fetch``
recorder and the L1's ``hit_rate``. Tolerance: exact placements,
counts, bytes and latencies (each node's latency draws follow the
order it serves requests, which is the same in both packages wherever
one read at a time runs)."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.cache import distributed as jdist  # noqa: E402
from repro.core.cache.hashring import HashRing as JRing  # noqa: E402
from repro.core.cache.hashring import HotKeyTracker as JHot  # noqa: E402
from repro.core.cache.local import LocalCache as JLocal  # noqa: E402
from repro.core.cache.lru_k import LRUK as JLRUK  # noqa: E402
from repro.core.telemetry import COUNTERS as JCOUNTERS  # noqa: E402
from repro_torch.core.cache import distributed as tdist  # noqa: E402
from repro_torch.core.cache.hashring import HashRing, HotKeyTracker  # noqa: E402
from repro_torch.core.cache.local import LocalCache  # noqa: E402
from repro_torch.core.cache.lru_k import LRUK  # noqa: E402
from repro_torch.core.telemetry import COUNTERS  # noqa: E402
from repro_torch.kernels.gf256.ops import rs_matmul_fn  # noqa: E402
from repro_torch.kernels.parity.ops import parity_fn_for_erasure  # noqa: E402


def _rings(n=6, **kw):
    nodes = [f"n{i}" for i in range(n)]
    return HashRing(nodes, **kw), JRing(nodes, **kw)


def test_bounded_load_sequence_matches_jax():
    """A bounded-load placement sequence with a node removed half way:
    the same node every step, the same loads."""
    ring, jring = _rings(load_factor=1.2)
    for i in range(600):
        if i == 300:
            ring.remove_node("n2")
            jring.remove_node("n2")
        got = ring.lookup(f"k{i}", count=1 + i % 3, bound_loads=True)
        assert got == jring.lookup(f"k{i}", count=1 + i % 3,
                                   bound_loads=True)
        ring.record_placement(got[0], weight=1 + i % 2)
        jring.record_placement(got[0], weight=1 + i % 2)
    assert ring.nodes == jring.nodes == ["n0", "n1", "n3", "n4", "n5"]
    assert dict(ring.loads) == dict(jring.loads)
    loads = np.array([ring.loads[n] for n in ring.nodes])
    assert loads.max() <= 1.2 * loads.mean() + 3
    # unbounded lookups ignore the loads and match the plain ring
    plain, _ = _rings()
    plain.remove_node("n2")
    for i in range(200):
        assert ring.lookup(f"c{i}", count=3) == plain.lookup(f"c{i}",
                                                              count=3)


def test_repeats_and_their_refusal_match_jax():
    ring, jring = _rings(n=3)
    assert ring.lookup("x", count=5) == jring.lookup("x", count=5)
    for cls in (HashRing, JRing):
        with pytest.raises(RuntimeError, match="only 3 nodes"):
            cls(["n0", "n1", "n2"]).lookup("x", count=5, allow_repeats=False)
        with pytest.raises(RuntimeError, match="empty ring"):
            cls([]).lookup("x")


def test_bounded_lookups_race_record_placement():
    """Bounded lookups from 8 threads beside ``record_placement``: no
    error and no lost placement (one locked snapshot per lookup)."""
    ring, _ = _rings(load_factor=1.2)
    errors = []

    def worker(w):
        try:
            for i in range(200):
                ring.record_placement(
                    ring.lookup(f"w{w}-k{i}", bound_loads=True)[0])
        except Exception as e:      # reported by the assertion below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert sum(ring.loads.values()) == 8 * 200


@pytest.mark.parametrize("window", [1, 7, 64])
def test_hot_key_tracker_window_matches_jax(window):
    rng = np.random.default_rng(window)
    hot, jhot = HotKeyTracker(3, window=window), JHot(3, window=window)
    keys = [f"k{int(i)}" for i in rng.zipf(1.5, 500) % 40]
    for k in keys:
        assert hot.record(k) == jhot.record(k)
        assert hot.rate(k) == jhot.rate(k)
        assert hot.is_hot(k) == jhot.is_hot(k)
    assert hot.window == jhot.window == window
    assert HotKeyTracker(0).record("a") is False
    assert HotKeyTracker(3, window=0).window == 1


def _caches(num_nodes=10, seed=4, **kw):
    port = tdist.DistributedCache(
        num_nodes=num_nodes, seed=seed, parity_fn=parity_fn_for_erasure("cpu"),
        matmul_fn=rs_matmul_fn("cpu"), **kw)
    return port, jdist.DistributedCache(num_nodes=num_nodes, seed=seed, **kw)


def _fill(caches, n=50, size=4096, seed=0):
    rng = np.random.default_rng(seed)
    datas = {f"c{i}": rng.integers(0, 256, size, np.uint8).tobytes()
             for i in range(n)}
    for cache in caches:
        for name, d in datas.items():
            cache.put_chunk(name, d)
    return datas


def test_unreplicated_reads_match_jax_sample_for_sample():
    """4-of-4 reads are sequential: bytes and latencies equal the
    reference's under the same seed and call order, healthy and with
    a data stripe's node crashed (a miss with the slowest latency)."""
    caches = _caches()
    datas = _fill(caches)
    for victim in (None, "cache-003"):
        if victim:
            for c in caches:
                c.fail_node(victim)
        for _ in range(3):
            for name, d in datas.items():
                got = [c.get_chunk_unreplicated(name, len(d)) for c in caches]
                assert got[0] == got[1]
                lost = victim in caches[0].ring.lookup(name, count=5)[:4]
                assert got[0][1] == (None if lost else d)
    assert caches[0].nodes["cache-003"].get_lat.samples == \
        caches[1].nodes["cache-003"].get_lat.samples


def test_fig9_tail_4of5_beats_4of4():
    """Fig. 9, ``test_erasure_beats_kofk_tail``: p99.9 of 4-of-5 reads
    below p99.9 of 4-of-4 reads, p99 not above."""
    port, _ = _caches()
    datas = _fill([port], size=65536)
    ec, kk = [], []
    for _ in range(40):
        for name, d in datas.items():
            lat, got = port.get_chunk(name, len(d))
            assert got == d
            ec.append(lat)
            kk.append(port.get_chunk_unreplicated(name, len(d))[0])
    assert np.percentile(ec, 99.9) < np.percentile(kk, 99.9)
    assert np.percentile(ec, 99) <= np.percentile(kk, 99)
    assert port.fetch_lat.samples == ec


def test_fail_flush_hit_rate_and_knobs_match_jax():
    caches = _caches(num_nodes=8, stripe_parallelism=3, hot_window=17)
    for c in caches:
        assert c.stripe_parallelism == 3 and c.hot.window == 17
    assert _caches(num_nodes=8)[0].stripe_parallelism == 20
    datas = _fill(caches, n=20, size=3000)
    name = "c7"
    for c in caches:
        victim = c.ring.lookup(name, count=5)[2]
        c.fail_node(victim)
        assert c.nodes[victim].failed
        assert c.get_chunk(name, 3000)[1] == datas[name]    # 4-of-5 holds
        for v in c.ring.lookup(name, count=5)[:2]:
            c.nodes[v].failed = True
        assert c.get_chunk(name, 3000)[1] is None            # two down
        for node in c.nodes.values():
            node.failed = False
        assert not any(n.failed for n in c.nodes.values())
        c.set_fault(victim, type(c.nodes[victim].fault).blackholed())
        assert c.nodes[victim].failed
        c.fail_node(victim, False)
        assert c.nodes[victim].fault.kind == "healthy"
    COUNTERS.reset()
    JCOUNTERS.reset()
    for c, counters in zip(caches, (COUNTERS, JCOUNTERS)):
        assert c.hit_rate == 0.0
        for n in datas:
            c.get_chunk(n, 3000)
        assert c.hit_rate == 1.0
        c.flush()
        assert all(not node.mem.keys() and not node.flash.keys()
                   for node in c.nodes.values())
        for n in datas:
            assert c.get_chunk(n, 3000)[1] is None
        assert c.hit_rate == 0.5
        assert counters.get("l2.hits") == counters.get("l2.misses") == 20
    assert caches[0].fetch_lat.samples == caches[1].fetch_lat.samples


def test_cache_node_knobs_and_recorders_match_jax():
    rng = np.random.default_rng(1)
    nodes = [mod.CacheNode("x", 1 << 20, 1 << 20, np.random.default_rng(9),
                           flash_extra_s=1e-3)
             for mod in (tdist, jdist)]
    model = tdist.LatencyModel(np.random.default_rng(2))
    assert tdist.CacheNode("y", 1, 1, None, latency=model).latency is model
    for node in nodes:
        for i in range(20):
            node.put(f"k{i}", rng.integers(0, 256, 100, np.uint8).tobytes())
        node.failed = True
        node.put("lost", b"z")
        node.get("k0")
        node.failed = False
        for i in range(25):
            node.get(f"k{i}")
    assert nodes[0].get_lat.samples == nodes[1].get_lat.samples
    assert nodes[0].put_lat.samples == nodes[1].put_lat.samples
    assert len(nodes[0].get_lat.samples) == 26


def test_local_cache_hit_rate_and_lru_keys_match_jax():
    COUNTERS.reset()
    JCOUNTERS.reset()
    for cls in (LocalCache, JLocal):
        l1 = cls(1 << 20, name="l1surface")
        assert l1.hit_rate == 0.0
        l1.put("a", b"1" * 100)
        l1.get("a")
        l1.get("a")
        l1.get("missing")
        assert l1.hit_rate == pytest.approx(2 / 3)
    assert (COUNTERS.get("l1surface.hits"),
            COUNTERS.get("l1surface.misses")) == (2.0, 1.0)
    caches = [cls(3 * 64, k=2) for cls in (LRUK, JLRUK)]
    for c in caches:
        for key in ("a", "b", "c", "d"):
            c.put(key, b"x" * 64)
        c.get("b")
    assert caches[0].keys() == caches[1].keys()
    assert len(caches[0].keys()) == 3
