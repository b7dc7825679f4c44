"""The port's origin resilience (``repro_torch.core.retry``,
``repro_torch.core.faults``) against the JAX package's, on the CPU: a
seeded ``RetryPolicy`` draws the JAX backoffs, a ``CircuitBreaker`` on a
fake clock walks the JAX state sequence, a seeded ``FaultyStore``
injects the JAX faults; then restores through port ``ImageService``s
(kernels' plain versions) recover transient errors and corrupt origin
bytes, an attempt deadline bounds a slow origin, uploads retry
transient PUT failures, a poisoned peer copy is deregistered, and an
open breaker sheds cold starts until one half-open probe heals it.
Tolerance: equal draws, states and counters; every restore equal byte
for byte to the JAX package's ``serial`` restore."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as jfaults  # noqa: E402
from repro.core import retry as jretry  # noqa: E402
from repro.core.loader import create_image  # noqa: E402
from repro.core.service import ImageService as JService  # noqa: E402
from repro.core.service import ReadPolicy as JPolicy  # noqa: E402
from repro.core.service import ServiceConfig as JConfig  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro.core.telemetry import Counters as JCounters  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import retry as tretry  # noqa: E402
from repro_torch.core.crypto.convergent import IntegrityError  # noqa: E402
from repro_torch.core.publish import PublishPipeline  # noqa: E402
from repro_torch.core.service import ColdStartRejected, ImageService, \
    ReadPolicy, ServiceConfig, build_peer_mesh  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.core.telemetry import COUNTERS, Counters  # noqa: E402
from repro_torch.models import DecoderLM, RunFlags, init_flat  # noqa: E402
from repro_torch.serve.coldstart import cold_start  # noqa: E402
from repro_torch.train.checkpoint import state_to_tree  # noqa: E402

CS = 4096
KEY = b"R" * 32
ROOT = "r0"
FAST_RETRY = dict(retry_attempts=4, retry_base_s=1e-4, retry_cap_s=1e-3,
                  retry_seed=1)
PKGS = {"port": (tretry, tfaults, Counters),
        "jax": (jretry, jfaults, JCounters)}


# --------------------------------------------------------- RetryPolicy

def test_seeded_backoffs_match_jax():
    draws, calls = {}, {}
    for pkg, (retry, faults, counters) in PKGS.items():
        p = retry.RetryPolicy(attempts=6, base_s=0.01, cap_s=0.05, seed=42)
        prev, seq = p.base_s, []
        for _ in range(200):
            prev = p.next_backoff(prev)
            seq.append(prev)
        draws[pkg] = seq
        q = retry.RetryPolicy(attempts=6, base_s=0.01, cap_s=0.04, seed=7)
        sleeps, n = [], []

        def fn():
            n.append(1)
            if len(n) < 5:
                raise faults.TransientStoreError("flaky")
            return "ok"
        cnt = counters()
        assert q.call(fn, counters=cnt, sleep=sleeps.append) == "ok"
        calls[pkg] = (sleeps, cnt.snapshot())
    assert draws["port"] == draws["jax"]
    assert all(0.01 <= d <= 0.05 for d in draws["port"])
    assert calls["port"] == calls["jax"]
    sleeps, snap = calls["port"]
    assert len(sleeps) == 4 and snap["retry.retries"] == 4


def test_zero_budget_policy_is_single_attempt(image):
    calls = []

    def fn():
        calls.append(1)
        raise tfaults.TransientStoreError("x")
    with pytest.raises(tfaults.TransientStoreError):
        tretry.RetryPolicy(attempts=1).call(
            fn, sleep=lambda s: pytest.fail("zero-budget policy slept"))
    assert len(calls) == 1
    d, blob, ref = image
    off, one = _svc(ChunkStore(d)), _svc(ChunkStore(d), retry_attempts=1)
    assert off.retry is None and one.retry is None and off.breaker is None
    for svc in (off, one):
        _same(svc.open(blob, KEY).restore_tree(), ref)


def test_retryable_classification_and_fail_fast():
    excs = [FileNotFoundError("missing"), TimeoutError(), ConnectionError(),
            ValueError("bug")]
    for retry, faults, _ in PKGS.values():
        got = [retry.is_retryable(e) for e in excs + [
            faults.TransientStoreError("t"), faults.StoreTimeoutError("t"),
            faults.StoreUnavailableError("u"), retry.BreakerOpenError(0.5)]]
        assert got == [False, True, True, False, True, True, True, True]
    calls = []

    def fn():
        calls.append(1)
        raise FileNotFoundError("deterministic bug")
    with pytest.raises(FileNotFoundError):
        tretry.RetryPolicy(attempts=5, base_s=1e-4, cap_s=1e-3).call(
            fn, counters=Counters(), sleep=lambda s: None)
    assert len(calls) == 1


def test_total_budget_refuses_next_sleep():
    cnt = Counters()
    p = tretry.RetryPolicy(attempts=10, base_s=1e-3, cap_s=1e-2,
                           total_budget_s=0.0)

    def fn():
        raise tfaults.TransientStoreError("always")
    with pytest.raises(tfaults.TransientStoreError):
        p.call(fn, counters=cnt, sleep=lambda s: None)
    assert (cnt.get("retry.attempts"), cnt.get("retry.budget_exhausted"),
            cnt.get("retry.giveups")) == (1, 1, 1)


def test_retry_after_hint_floors_the_backoff():
    p = tretry.RetryPolicy(attempts=2, base_s=1e-4, cap_s=1e-3)
    sleeps, calls = [], []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            raise tretry.BreakerOpenError(0.25)
        return "ok"
    assert p.call(fn, counters=Counters(), sleep=sleeps.append) == "ok"
    assert len(sleeps) == 1 and sleeps[0] >= 0.25


# ------------------------------------------------------- CircuitBreaker

_BREAKER_SCRIPT = (
    ["fail"] * 3 + ["allow"] + ["fail"] + ["allow", "after"]
    + [("tick", 0.4), "allow", "after", ("tick", 1.0), "allow", "allow",
       "succ", "allow"]
    + ["succ", "succ", "fail"] * 4
    + ["fail"] * 4 + [("tick", 2.0), "allow", "fail", "after",
                      ("tick", 2.5), "state", ("tick", 3.0), "state",
                      "allow", "succ", "state"])


def _walk_breaker(retry, counters):
    clk = {"t": 0.0}
    cnt = counters()
    br = retry.CircuitBreaker(0.5, window=8, min_samples=4, cooldown_s=1.0,
                              half_open_probes=1, counters=cnt,
                              clock=lambda: clk["t"])
    seq = []
    for op in _BREAKER_SCRIPT:
        if isinstance(op, tuple):
            clk["t"] = op[1]
            continue
        if op == "fail":
            br.record_failure()
        elif op == "succ":
            br.record_success()
        elif op == "allow":
            seq.append(("allow", br.allow()))
        elif op == "after":
            seq.append(("after", round(br.retry_after_s(), 9)))
        seq.append(br.state)
    return seq, cnt.snapshot()


def test_breaker_walks_the_jax_state_sequence():
    port = _walk_breaker(tretry, Counters)
    assert port == _walk_breaker(jretry, JCounters)
    seq, snap = port
    states = [s for s in seq if isinstance(s, str)]
    assert {"closed", "open", "half_open"} <= set(states)
    assert ("allow", False) in seq and ("after", 0.6) in seq
    assert snap["breaker.opened"] == 3 and snap["breaker.closed"] == 2


# ---------------------------------------------------------- FaultyStore

def test_faulty_store_injects_the_jax_faults(image):
    d, blob, _ = image
    names = sorted(p.name for p in (d / "roots" / ROOT / "chunks")
                   .glob("*/*"))[:6]
    out = {}
    for pkg, (_, faults, counters) in PKGS.items():
        inner = ChunkStore(d) if pkg == "port" else JStore(d)
        cnt = counters()
        fs = faults.FaultyStore(inner, faults.OriginFaultPlan.flaky(
            error_p=0.3, corrupt_p=0.3), seed=5, counters=cnt)
        seq = []
        fs.fail_next(2)
        fs.corrupt_next(1)
        for i in range(40):
            name = names[i % len(names)]
            try:
                data = fs.get_chunk(ROOT, name)
                seq.append(data == inner.get_chunk(ROOT, name))
            except faults.TransientStoreError as e:
                seq.append(type(e).__name__)
        fs.set_fault(faults.OriginFaultPlan.unavailable())
        with pytest.raises(faults.StoreUnavailableError):
            fs.get_chunk(ROOT, names[0])
        fs.set_fault(faults.OriginFaultPlan.healthy())
        fs.fail_next(1)
        with pytest.raises(faults.TransientStoreError):
            fs.put_if_absent(ROOT, names[0], b"x")
        assert fs.get_chunk(ROOT, names[0]) == inner.get_chunk(ROOT, names[0])
        out[pkg] = (seq, cnt.snapshot())
    assert out["port"] == out["jax"]
    seq, snap = out["port"]
    assert seq[:2] == ["TransientStoreError"] * 2 and seq[2] is False
    assert True in seq and snap["faults.origin_corrupt"] >= 1


# ------------------------------------------------- restores that recover

@pytest.fixture(scope="module")
def image(tmp_path_factory):
    """An image of 6 distinct 4 KiB chunks made by the JAX package, and
    its ``serial``-backend restore."""
    d = tmp_path_factory.mktemp("res-image")
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal(6 * CS // 4).astype(np.float32)}
    blob, _ = create_image(tree, tenant="res", tenant_key=KEY,
                           store=JStore(d), root=ROOT, chunk_size=CS)
    jsvc = JService(JStore(d), JConfig(l1_bytes=0))
    ref = jsvc.open(blob, KEY).restore_tree(
        policy=JPolicy(mode="staged", decode_backend="serial"))
    jsvc.close()
    return d, blob, ref


def _svc(store, peer=None, **kw):
    base = dict(device="cpu", root=ROOT, l1_bytes=0, fetch_concurrency=0,
                max_coldstarts=0)
    base.update(kw)
    return ImageService(store, ServiceConfig(**base), peer=peer)


def _same(flat, ref):
    assert flat.keys() == ref.keys()
    for k in ref:
        assert flat[k].tobytes() == ref[k].tobytes(), k


def test_transient_origin_errors_recovered(image):
    d, blob, ref = image
    fs = tfaults.FaultyStore(ChunkStore(d))
    fs.fail_next(2)
    svc = _svc(fs, **FAST_RETRY)
    before = COUNTERS.get("retry.retries")
    _same(svc.open(blob, KEY).restore_tree(
        policy=ReadPolicy(parallelism=4)), ref)
    assert COUNTERS.get("retry.retries") - before >= 2


def test_corrupt_origin_raises_without_retry(image):
    d, blob, _ = image
    fs = tfaults.FaultyStore(ChunkStore(d))
    fs.corrupt_next(1)
    with pytest.raises(IntegrityError):
        _svc(fs).open(blob, KEY).restore_tree(
            policy=ReadPolicy(mode="serial"))


@pytest.mark.parametrize("mode", ["serial", "staged", "streamed"])
def test_corrupt_origin_evicts_and_refetches(image, mode):
    d, blob, ref = image
    fs = tfaults.FaultyStore(ChunkStore(d))
    fs.corrupt_next(1)
    svc = _svc(fs, l1_bytes=8 << 20, **FAST_RETRY)
    before = COUNTERS.get("retry.integrity_refetches")
    pol = ReadPolicy(mode=mode, parallelism=4)
    _same(svc.open(blob, KEY).restore_tree(policy=pol), ref)
    assert COUNTERS.get("retry.integrity_refetches") - before >= 1
    # the bad ciphertext did not stay in the (now warm) L1
    _same(svc.open(blob, KEY).restore_tree(policy=pol), ref)


def test_attempt_deadline_bounds_slow_origin(image):
    d, blob, _ = image
    fs = tfaults.FaultyStore(ChunkStore(d),
                             tfaults.OriginFaultPlan.slow(delay_s=0.5))
    svc = _svc(fs, retry_attempts=2, retry_base_s=1e-4, retry_cap_s=1e-3,
               retry_attempt_timeout_s=0.005)
    before = COUNTERS.get("faults.origin_timeouts")
    t0 = time.perf_counter()
    with pytest.raises(tfaults.StoreTimeoutError):
        svc.open(blob, KEY).restore_tree(policy=ReadPolicy(mode="serial"))
    assert time.perf_counter() - t0 < 0.5       # never paid the stall
    assert COUNTERS.get("faults.origin_timeouts") - before == 2


# ----------------------------------------------------------- write path

def test_upload_retries_transient_put_failures(tmp_path):
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal(4 * CS // 4).astype(np.float32)}
    store = ChunkStore(tmp_path / "s")
    fs = tfaults.FaultyStore(store)
    fs.fail_next(1)
    plain = PublishPipeline(fs, backend="python", device="cpu")
    with pytest.raises(tfaults.TransientStoreError):
        plain.publish(tree, tenant="res", tenant_key=KEY, root=ROOT,
                      chunk_size=CS)
    plain.close()
    fs.fail_next(2)
    pipe = PublishPipeline(fs, backend="python", device="cpu",
                           retry=tretry.RetryPolicy(attempts=4, base_s=1e-4,
                                                    cap_s=1e-3, seed=2))
    before = COUNTERS.get("retry.retries")
    blob, _ = pipe.publish(tree, tenant="res", tenant_key=KEY, root=ROOT,
                           chunk_size=CS)
    pipe.close()
    assert COUNTERS.get("retry.retries") - before >= 2
    jref = JService(JStore(tmp_path / "s"), JConfig(l1_bytes=0)).open(
        blob, KEY).restore_tree(policy=JPolicy(mode="staged",
                                               decode_backend="serial"))
    assert jref["w"].tobytes() == tree["w"].tobytes()


# ----------------------------------------------------------- peer tier

def _flip(data: bytes, pos: int = 0) -> bytes:
    return data[:pos] + bytes([data[pos] ^ 0xFF]) + data[pos + 1:]


def test_poisoned_peer_copy_deregistered(image):
    """A holder advertising corrupt bytes is dropped from the mesh on
    the integrity failure; with a retry policy the read heals from the
    origin and the fresh copy re-registers under this worker."""
    d, blob, ref = image
    store = ChunkStore(d)
    mesh = build_peer_mesh(ServiceConfig(device="cpu"), 2)
    h = _svc(store, peer=mesh.client(0)).open(blob, KEY)
    name = h.manifest.chunks[0].name
    bad = _flip(store.get_chunk(ROOT, name))
    mesh.client(1).put_chunk(name, bad, source="origin")
    assert 1 in mesh.holders(name)
    with pytest.raises(IntegrityError):
        h.reader.fetch_chunk(0)
    assert mesh.holders(name) == []

    mesh.client(1).put_chunk(name, bad, source="origin")
    svc2 = _svc(store, peer=mesh.client(0), **FAST_RETRY)
    before = COUNTERS.get("retry.integrity_refetches")
    plain = svc2.open(blob, KEY).reader.fetch_chunk(0)
    assert plain == ref["w"].tobytes()[:CS]
    assert COUNTERS.get("retry.integrity_refetches") - before == 1
    assert mesh.holders(name) == [0]


# ------------------------------------------------------------ brownout

def test_brownout_sheds_then_heals_through_one_probe(tmp_path):
    """Origin down: two failed reads open the breaker; ``cold_start``
    is then shed with a retry-after; once the fake clock passes the
    cooldown and the origin is back, one half-open probe closes the
    breaker and the cold start loads the model."""
    cfg = get_config("smollm-360m").reduced()
    flat = init_flat(cfg, 3)
    store = ChunkStore(tmp_path / "s")
    pub = PublishPipeline(store, backend="python", device="cpu")
    blob, _ = pub.publish(flat, tenant="res", tenant_key=KEY, root=ROOT,
                          chunk_size=CS)
    pub.close()
    fs = tfaults.FaultyStore(store, tfaults.OriginFaultPlan.unavailable())
    svc = _svc(fs, max_coldstarts=2, breaker_threshold=0.5,
               breaker_min_samples=2, breaker_window=8,
               breaker_cooldown_s=1.0)
    clk = {"t": 100.0}
    svc.breaker._clock = lambda: clk["t"]
    serial = ReadPolicy(mode="serial")
    h = svc.open(blob, KEY)
    for _ in range(2):
        with pytest.raises(tfaults.StoreUnavailableError):
            h.restore_tree(policy=serial)
    assert svc.breaker.state == "open"
    model = DecoderLM(cfg, RunFlags(dtype="float32"), device="cpu")
    before = COUNTERS.snapshot()
    with pytest.raises(ColdStartRejected) as ei:
        cold_start(model, blob, KEY, svc, policy=serial)
    assert ei.value.retry_after_s == pytest.approx(1.0)
    after = COUNTERS.snapshot()
    assert after.get("serve.brownout_shed", 0) - \
        before.get("serve.brownout_shed", 0) == 1
    assert svc.admission.rejected == 1 and svc.admission.inflight == 0

    fs.set_fault(tfaults.OriginFaultPlan.healthy())
    clk["t"] += 1.0                     # cooldown over: half-open
    assert svc.breaker.state == "half_open"
    _, stats = cold_start(model, blob, KEY, svc, policy=serial)
    assert svc.breaker.state == "closed"
    after2 = COUNTERS.snapshot()
    for k, want in (("breaker.probes", 1), ("breaker.closed", 1),
                    ("breaker.opened", 0)):
        assert after2.get(k, 0) - after.get(k, 0) == want, k
    assert stats["origin_fetches"] > 0
    got = state_to_tree(model.params)
    for k, v in flat.items():
        assert got[k].tobytes() == v.tobytes(), k
