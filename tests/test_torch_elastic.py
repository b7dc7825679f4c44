"""The port's elastic coordinator (``repro_torch.train.elastic``) on the
CPU: the JAX package's ``TestElastic`` cases
(``tests/test_checkpoint_elastic.py``) over the port's checkpoint readers, and the recovery plan against the
JAX coordinator's over the same image (exact: the same chunk list,
fraction and shard slices).

Failure detection, straggler flags and the rescale plan on the same
inputs give the JAX coordinator's results and events. A replacement
worker's shard (dim 0 split four ways) fetches at most half of the
image and exactly its plan's chunks; after another worker's restore
warmed an L2 (with a stripe deadline long enough that no simulated
tail drops a stripe), recovery makes no origin GET."""
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.loader import ImageReader as JReader  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro.train.elastic import \
    ElasticCoordinator as JCoordinator  # noqa: E402
from repro_torch.core.cache.distributed import DistributedCache  # noqa: E402
from repro_torch.core.gc import GenerationalGC  # noqa: E402
from repro_torch.core.manifest import ZERO_CHUNK  # noqa: E402
from repro_torch.core.service import ImageService, ServiceConfig  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.core.telemetry import COUNTERS  # noqa: E402
from repro_torch.kernels.gf256.ops import rs_matmul_fn  # noqa: E402
from repro_torch.kernels.parity.ops import parity_fn_for_erasure  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.elastic import ElasticCoordinator  # noqa: E402

KEY = b"C" * 32


def dim0(n):
    return lambda name, shape: [n] + [1] * (len(shape) - 1)


@pytest.fixture
def env(tmp_path):
    store = ChunkStore(tmp_path / "ck")
    gc = GenerationalGC(store)
    ck = CheckpointManager(store, gc, tenant="train", tenant_key=KEY,
                           chunk_size=16384, async_upload=False,
                           device="cpu")
    return store, gc, ck


def _events(co):
    return [e[:2] for e in co.events]


def test_failure_detection():
    cos = ElasticCoordinator(2, 2, heartbeat_timeout=1.0), \
        JCoordinator(2, 2, heartbeat_timeout=1.0)
    now = time.time()
    failed = []
    for co in cos:
        for wid in co.workers:
            co.heartbeat(wid, now=now)
        co.heartbeat("w-0-0", now=now + 5)
        failed.append(co.detect_failures(now=now + 5))
    assert set(failed[0]) == {"w-0-1", "w-1-0", "w-1-1"}
    assert failed[0] == failed[1] and _events(cos[0]) == _events(cos[1])


def test_straggler_detection():
    got = []
    for co in (ElasticCoordinator(2, 2), JCoordinator(2, 2)):
        for wid in co.workers:
            for _ in range(6):
                co.heartbeat(wid, step_latency=1.0)
        for _ in range(6):
            co.heartbeat("w-1-1", step_latency=10.0)
        got.append(co.stragglers(factor=3.0))
    assert got[0] == got[1] == ["w-1-1"]


def test_shard_recovery_fraction(env):
    """A replacement worker fetches ~1/mp of the image, not all of it,
    by the JAX coordinator's plan."""
    store, gc, ck = env
    rng = np.random.default_rng(2)
    state = {f"layer{i}/w": rng.standard_normal((256, 128)).astype(np.float32)
             for i in range(4)}
    ck.save(1, state)
    rec = ck.records[-1]
    ck.service = ImageService(store, ServiceConfig(
        device="cpu", decode_backend="python", l1_bytes=0))
    reader = ck.reader(rec)
    co = ElasticCoordinator(2, 4)
    co.kill("w-0-2")
    plan = co.plan_recovery("w-0-2", reader, param_specs_fn=dim0(4))
    assert 0 < plan["chunk_fraction"] <= 0.5
    jreader = JReader(store.get_manifest(rec.root, rec.image_id), KEY,
                      JStore(store.dir), root=rec.root)
    jco = JCoordinator(2, 4)
    jco.kill("w-0-2")
    jplan = jco.plan_recovery("w-0-2", jreader, param_specs_fn=dim0(4))
    assert plan == jplan
    before = COUNTERS.get("read.origin_fetches")
    stats = co.execute_recovery(plan, reader)
    assert co.workers["w-0-2"].alive
    assert stats["chunks"] == len(plan["chunks"])
    names = {reader.manifest.chunks[i].name for i in plan["chunks"]} \
        - {ZERO_CHUNK}
    assert COUNTERS.get("read.origin_fetches") - before == len(names)
    assert stats["origin_fetches"] == len(names)
    ck.service.close()


def test_recovery_through_warm_cache_no_origin(env):
    store, gc, ck = env
    rng = np.random.default_rng(3)
    state = {"w": rng.standard_normal((512, 256)).astype(np.float32)}
    ck.save(1, state)
    l2 = DistributedCache(num_nodes=4, seed=0,
                          parity_fn=parity_fn_for_erasure("cpu"),
                          matmul_fn=rs_matmul_fn("cpu"),
                          stripe_deadline_s=5.0)
    # first worker warms L2
    ck.l2 = l2
    r1 = ck.reader(ck.records[-1])
    np.testing.assert_array_equal(r1.restore_tree()["w"], state["w"])
    COUNTERS.reset()
    r2 = ck.reader(ck.records[-1])
    co = ElasticCoordinator(1, 2)
    co.kill("w-0-1")
    plan = co.plan_recovery("w-0-1", r2, param_specs_fn=dim0(2))
    stats = co.execute_recovery(plan, r2)
    assert stats["origin_fetches"] == 0     # pure L2 recovery
    assert stats["chunks"] == len(plan["chunks"]) > 0


def test_rescale():
    for co in (ElasticCoordinator(4, 2), JCoordinator(4, 2)):
        plan = co.rescale_plan(3)
        assert plan == {"old_dp": 4, "new_dp": 3,
                        "batch_per_replica_factor": 4 / 3,
                        "weights_moved_bytes": 0}
        assert co.dp == 3
