"""The port's peer tier (``repro_torch.core.cache.peer``) against the JAX
package's, on the CPU: one scripted mesh sequence run through both
meshes with the same seed (lead, publish, direct hits, the ``"origin"``
registration policy, a crashed holder, tree repair past a dead parent,
``invalidate``, ``probe_chunks`` with inline hits, leads and joins),
leader promotion on ``abandon``, ``build_peer_mesh``, and restores
through port ``ImageService`` workers sharing one mesh: a peer-only
second worker, a storm, a storm with a peer crashed mid-transfer, and
a storm over a slow origin whose leading worker crashes after a few
transfers. Tolerance: the same latencies (the same numpy streams), directory and
counter deltas; every restore equal byte for byte to the JAX package's
``serial`` restore.

The storms run 4 workers: on the CPU each worker decodes through the
fused kernel's plain PyTorch version, whose per-round operations make
threads contend for the interpreter lock, so a wider storm takes
seconds per worker."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.cache import distributed as jdist  # noqa: E402
from repro.core.cache import peer as jpeer  # noqa: E402
from repro.core.loader import create_image  # noqa: E402
from repro.core.service import ImageService as JService  # noqa: E402
from repro.core.service import ReadPolicy as JPolicy  # noqa: E402
from repro.core.service import ServiceConfig as JConfig  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro.core.telemetry import COUNTERS as JCOUNTERS  # noqa: E402
from repro_torch.core.cache import distributed as tdist  # noqa: E402
from repro_torch.core.cache import peer as tpeer  # noqa: E402
from repro_torch.core.service import ImageService, ReadPolicy, \
    ServiceConfig, build_peer_mesh  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.core.telemetry import COUNTERS  # noqa: E402

CS = 1024
KEY = b"P" * 32
ROOT = "r0"
CT = b"\xabCIPHERTEXT" * 37
PEER_COUNTERS = ("peer.transfers", "peer.direct_hits", "peer.tree_hits",
                 "peer.joins", "peer.misses", "peer.hits", "peer.promotions",
                 "peer.dead_peer_fallthroughs", "peer.deadline_fallthroughs",
                 "peer.registered_chunks", "peer.tree_repairs",
                 "peer.abandoned_leases")
POLICY = ReadPolicy(mode="streamed", parallelism=2)
PKGS = {"port": (tpeer, tdist, COUNTERS), "jax": (jpeer, jdist, JCOUNTERS)}


# ------------------------------------------------------- scripted mesh

def _mesh_script(peer, dist):
    """One fixed sequence of mesh operations; returns what each step
    returned (latencies and whether the bytes came back), the
    directories, the serving copies and the transfer hook's events."""
    rec, events = [], []
    hook = (lambda name, src, dst: events.append((name, src, dst)))
    crashed = dist.FaultPlan.crashed()

    def step(label, res):
        lat, ct = res
        rec.append((label, lat, None if ct is None else ct == CT))

    # lead, publish, direct hits from one and then two holders
    mesh = peer.PeerMesh(5, seed=3, transfer_hook=hook)
    c = [mesh.client(i) for i in range(5)]
    step("lead", c[0].get_chunk("a", len(CT)))
    c[0].put_chunk("a", CT, source="origin")
    step("direct 1", c[1].get_chunk("a", len(CT)))
    step("direct 2", c[2].get_chunk("a", len(CT)))
    # a crashed holder is skipped; with every holder dead, fall through
    mesh.set_fault(0, crashed)
    step("skip dead holder", c[3].get_chunk("a", len(CT)))
    step("lead b", c[1].get_chunk("b", len(CT)))
    c[1].put_chunk("b", CT, source="origin")
    mesh.set_fault(1, crashed)
    step("all holders dead", c[4].get_chunk("b", len(CT)))
    c[4].abandon("b")
    # invalidate drops every copy; the next miss leads again
    c[2].invalidate("a")
    step("after invalidate", c[3].get_chunk("a", len(CT)))
    c[3].put_chunk("a", CT, source="l2")
    step("l2-sourced holder", c[2].get_chunk("a", len(CT)))

    # registration "origin": receivers and L2 sources are not advertised
    mo = peer.PeerMesh(3, registration="origin", seed=1)
    o = [mo.client(i) for i in range(3)]
    step("origin lead", o[0].get_chunk("n1", len(CT)))
    o[0].put_chunk("n1", CT, source="origin")
    step("origin direct", o[1].get_chunk("n1", len(CT)))
    step("origin lead n2", o[1].get_chunk("n2", len(CT)))
    o[1].put_chunk("n2", CT, source="l2")

    # tree repair: fanout 1, leader <- j1 <- j2, j1 dies before resolve
    mt = peer.PeerMesh(3, fanout=1, seed=5, transfer_hook=hook)
    t = [mt.client(i) for i in range(3)]
    step("tree lead", t[0].get_chunk("t", len(CT)))
    ready = []
    on_ready = (lambda name, lat, ct: ready.append((name, lat)))
    _, f1 = t[1].probe_chunks(["t"], len(CT), on_ready)
    _, f2 = t[2].probe_chunks(["t"], len(CT), on_ready)
    mt.set_fault(1, crashed)
    t[0].put_chunk("t", CT, source="origin")
    step("tree j1", f1["t"].result(timeout=10))
    step("tree j2 repaired", f2["t"].result(timeout=10))

    # probe_chunks: an inline holder hit, a join, a lead
    mp = peer.PeerMesh(4, seed=2)
    p = [mp.client(i) for i in range(4)]
    step("probe held lead", p[0].get_chunk("held", len(CT)))
    p[0].put_chunk("held", CT, source="origin")
    step("probe flying lead", p[0].get_chunk("flying", len(CT)))
    leads, futs = p[1].probe_chunks(["held", "flying", "fresh"], len(CT),
                                    on_ready)
    p[0].put_chunk("flying", CT, source="origin")
    step("probe join", futs["flying"].result(timeout=10))
    rec.append(("probe leads", leads, sorted(futs)))
    rec.append(("ready", sorted(ready)))

    def state(m):
        with m._lock:
            return ({n: sorted(ids) for n, ids in m.directory.items()},
                    [sorted(w.chunks) for w in m.workers],
                    sorted(m.flights))
    rec.append(("state", [state(m) for m in (mesh, mo, mt, mp)]))
    rec.append(("events", sorted(events)))
    return rec


def test_scripted_mesh_matches_jax():
    out = {}
    for pkg, (peer, dist, counters) in PKGS.items():
        before = {k: counters.get(k) for k in PEER_COUNTERS}
        rec = _mesh_script(peer, dist)
        out[pkg] = (rec, {k: counters.get(k) - before[k]
                          for k in PEER_COUNTERS})
    assert out["port"] == out["jax"]
    rec, deltas = out["port"]
    steps = {r[0]: r[1:] for r in rec}
    assert steps["lead"] == (0.0, None)
    assert steps["direct 1"][1] is True and steps["direct 1"][0] > 0
    assert steps["skip dead holder"][1] is True
    assert steps["all holders dead"] == (0.0, None)
    assert steps["after invalidate"][1] is None
    assert steps["origin direct"][1] is True
    assert steps["tree j2 repaired"][1] is True
    assert steps["probe leads"] == (["fresh"], ["flying"])
    state = steps["state"][0]
    assert state[1][0] == {"n1": [0]}                 # "origin" policy
    assert "n2" in state[1][1][1]                     # serving copy only
    assert deltas["peer.tree_repairs"] == 1
    assert deltas["peer.dead_peer_fallthroughs"] >= 1


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_abandon_promotes_first_joiner(pkg):
    peer, _dist, counters = PKGS[pkg]
    mesh = peer.PeerMesh(3)
    c0, c1 = mesh.client(0), mesh.client(1)
    assert c0.get_chunk("n", len(CT))[1] is None
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "r", c1.get_chunk("n", len(CT))))
    t.start()
    deadline = time.time() + 5
    while time.time() < deadline:
        with mesh._lock:
            if mesh.flights["n"].joiners:
                break
        time.sleep(0.002)
    before = counters.get("peer.promotions")
    c0.abandon("n")                     # c0's lower-tier fetch failed
    t.join(10)
    assert out["r"][1] is None          # c1 now leads: it falls through
    assert counters.get("peer.promotions") - before == 1
    c1.put_chunk("n", CT, source="origin")
    assert mesh.client(2).get_chunk("n", len(CT))[1] == CT
    c0.abandon("n")                     # no flight left: a no-op
    assert mesh.flights == {}


def test_build_peer_mesh_from_config():
    cfg = ServiceConfig(device="cpu", peer_fanout=7, peer_deadline_s=0.5,
                        peer_registration="origin")
    mesh = build_peer_mesh(cfg, 5, seed=3)
    assert isinstance(mesh, tpeer.PeerMesh)
    assert len(mesh.workers) == 5
    assert (mesh.fanout, mesh.deadline_s, mesh.registration) == \
        (7, 0.5, "origin")
    d = ServiceConfig(device="cpu")
    j = JConfig()
    assert (d.peer_fanout, d.peer_deadline_s, d.peer_registration) == \
        (j.peer_fanout, j.peer_deadline_s, j.peer_registration)
    with pytest.raises(ValueError):
        tpeer.PeerMesh(2, registration="bogus")


# ----------------------------------------------- restores over the mesh

class CountingStore(ChunkStore):
    def __init__(self, root_dir, delay_s: float = 0.0):
        super().__init__(root_dir)
        self.gets = 0
        self.delay_s = delay_s
        self._lock = threading.Lock()

    def get_chunk(self, root, name):
        with self._lock:
            self.gets += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        return super().get_chunk(root, name)


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    """An image of 40 distinct 1 KiB chunks and 3 zero chunks made by
    the JAX package, and its ``serial``-backend restore."""
    d = tmp_path_factory.mktemp("peer-image")
    rng = np.random.default_rng(9)
    tree = {"w": rng.standard_normal(40 * CS // 4).astype(np.float32),
            "zeros": np.zeros(3 * CS, np.uint8)}
    blob, stats = create_image(tree, tenant="t", tenant_key=KEY,
                               store=JStore(d), root=ROOT, chunk_size=CS)
    return d, blob, _jax_restore(d, blob), stats.unique_chunks


def _jax_restore(d, blob, mode="staged"):
    """The JAX package's ``serial``-backend restore of `blob` in `d`."""
    jsvc = JService(JStore(d), JConfig(l1_bytes=0))
    ref = jsvc.open(blob, KEY).restore_tree(
        policy=JPolicy(mode=mode, decode_backend="serial"))
    jsvc.close()
    return ref


def _worker(store, mesh, i, cfg=None, client=None):
    cfg = cfg if cfg is not None else ServiceConfig(device="cpu", root=ROOT)
    return ImageService(store, cfg, peer=client or mesh.client(i))


def _same(flat, ref):
    assert flat.keys() == ref.keys()
    for k in ref:
        assert flat[k].tobytes() == ref[k].tobytes(), k


def _storm(store, blob, mesh, n, cfg=None, clients=None, policy=POLICY):
    workers = [_worker(store, mesh, i, cfg, clients and clients[i])
               for i in range(n)]
    barrier = threading.Barrier(n)
    out, errs = {}, []

    def work(i):
        try:
            barrier.wait(timeout=30)
            out[i] = workers[i].open(blob, KEY).restore_tree(policy=policy)
        except Exception as e:          # reported by the caller's assert
            errs.append(e)
    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for w in workers:
        w.close()
    assert not errs, errs
    return out


def test_second_worker_restores_peer_only(image):
    d, blob, ref, unique = image
    store = CountingStore(d)
    mesh = build_peer_mesh(ServiceConfig(device="cpu"), 2, seed=1)
    _same(_worker(store, mesh, 0).open(blob, KEY).restore_tree(
        policy=POLICY), ref)
    assert store.gets == unique
    before = COUNTERS.get("read.peer_hits")
    for mode in ("streamed", "staged", "serial"):
        w = _worker(store, mesh, 1)
        _same(w.open(blob, KEY).restore_tree(
            policy=ReadPolicy(mode=mode, parallelism=2)), ref)
        w.close()
    assert store.gets == unique         # no origin GET after worker 0
    assert COUNTERS.get("read.peer_hits") - before >= unique


def test_storm_dedups_origin_and_matches_oracle(image):
    d, blob, ref, unique = image
    store = CountingStore(d)
    n = 4
    mesh = build_peer_mesh(ServiceConfig(device="cpu"), n, seed=2)
    before = COUNTERS.get("peer.transfers")
    out = _storm(store, blob, mesh, n)
    assert unique <= store.gets <= 2 * unique
    assert COUNTERS.get("peer.transfers") - before > 0
    for i in range(n):
        _same(out[i], ref)


def test_crashed_peer_mid_storm_stays_byte_identical(image):
    d, blob, ref, unique = image
    store = CountingStore(d)
    n = 4
    crashed = []
    mesh = build_peer_mesh(ServiceConfig(device="cpu"), n, seed=4)

    def crash_src(name, src, dst):
        if not crashed:
            crashed.append(src)
            mesh.set_fault(src, tdist.FaultPlan.crashed())
    mesh.transfer_hook = crash_src
    out = _storm(store, blob, mesh, n)
    assert crashed                      # the hook fired
    for i in range(n):
        _same(out[i], ref)


# A crashed leader. The worker that leads every flight of the storm stops
# serving after LEADER_CRASH_AFTER transfers; its own restore goes on,
# so it still resolves each flight, and each flight's joiners, cut off
# from the dead leader, elect one of themselves to fetch the name from
# the origin. The elected orphan must fetch at once, not after its
# other joins have finished, or its fellow orphans sit out the peer
# deadline and fetch the name again: past twice the distinct chunks.
STORM_CHUNKS = 240
LEADER_CRASH_AFTER = 5
ORIGIN_DELAY_S = 0.1
STORM_DEADLINE_S = 1.0


def test_crashed_leader_storm_stays_within_twice_unique(tmp_path):
    rng = np.random.default_rng(12)
    tree = {"w": rng.standard_normal(STORM_CHUNKS * CS // 4)
            .astype(np.float32)}
    cfg = ServiceConfig(device="cpu", root=ROOT, decode_backend="python",
                        peer_deadline_s=STORM_DEADLINE_S)
    pub = ImageService(ChunkStore(tmp_path), cfg)
    blob, stats = pub.publish(tree, tenant="t", tenant_key=KEY,
                              chunk_size=CS)
    pub.close()
    unique = stats.unique_chunks
    assert unique == STORM_CHUNKS
    ref = _jax_restore(tmp_path, blob, mode="serial")
    store = CountingStore(tmp_path, delay_s=ORIGIN_DELAY_S)
    n = 4
    led = [0] * n
    crashed = []
    lock = threading.Lock()

    def crash_leader(name, src, dst):
        if crashed or mesh.workers[src].served < LEADER_CRASH_AFTER \
                or led[src] < max(led):
            return
        with lock:
            if not crashed:
                crashed.append(src)
                mesh.set_fault(src, tdist.FaultPlan.crashed())
    mesh = build_peer_mesh(cfg, n, seed=6, transfer_hook=crash_leader)
    clients = [mesh.client(i) for i in range(n)]
    # One probe at a time, so the first worker to probe leads every
    # flight whatever the scheduler does; without it a worker that
    # starts late on a busy host can catch up with the leader's probe
    # loop and lead the rest.
    probing = threading.Lock()
    for i, client in enumerate(clients):    # count the flights each leads
        def counted(names, chunk_len, on_ready, _probe=client.probe_chunks,
                    _i=i):
            with probing:
                leads, futs = _probe(names, chunk_len, on_ready)
            led[_i] += len(leads)
            return leads, futs
        client.probe_chunks = counted
    out = _storm(store, blob, mesh, n, cfg, clients,
                 ReadPolicy(mode="streamed", parallelism=8))
    assert crashed and led[crashed[0]] == unique
    assert store.gets <= 2 * unique, (store.gets, unique)
    for i in range(n):
        _same(out[i], ref)
