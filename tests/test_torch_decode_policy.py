"""The port's decode-stage policy against the JAX package's, on the CPU:
the idle-queue eager flush and its ``eager_min_bytes`` hold, idle
session expiry, the decoder pool's key, and the tile autotuner's
machinery (untimed warmups, a budget of timed runs only, per-backend
pending events, the per-process cache, ``REPRO_NO_AUTOTUNE``, explicit
tiles). Images are made by the JAX package's ``create_image`` and read
by both packages' services with the ``python`` backend."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.decode as jdec  # noqa: E402
from repro.core.gc import GenerationalGC  # noqa: E402
from repro.core.loader import create_image  # noqa: E402
from repro.core.service import ImageService as JService  # noqa: E402
from repro.core.service import ReadPolicy as JPolicy  # noqa: E402
from repro.core.service import ServiceConfig as JConfig  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro_torch.core import decode as dec  # noqa: E402
from repro_torch.core.service import ImageService, ReadPolicy, \
    ServiceConfig  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.core.telemetry import COUNTERS  # noqa: E402

CS = 4096
KEY = b"E" * 32


def _image(tmp_path, nchunks, seed):
    store = JStore(tmp_path / "s")
    root = GenerationalGC(store).active
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((CS * nchunks // 4,)).astype(np.float32)}
    blob, _ = create_image(tree, tenant="t", tenant_key=KEY, store=store,
                           root=root, chunk_size=CS)
    return tmp_path / "s", tree, blob


def _slow_cfg(cls, **kw):
    base = dict(l1_bytes=8 << 20, l2_nodes=0, fetch_concurrency=0,
                origin_delay_s=0.01, max_batch_bytes=64 << 20,
                decode_backend="python")
    base.update(kw)
    if cls is ServiceConfig:
        base["device"] = "cpu"
    return cls(**base)


def _restore(pkg, store_dir, blob, policy_kw, **cfg_kw):
    svc_cls, cfg_cls, pol_cls, store_cls = (
        (ImageService, ServiceConfig, ReadPolicy, ChunkStore) if pkg == "port"
        else (JService, JConfig, JPolicy, JStore))
    svc = svc_cls(store_cls(store_dir), _slow_cfg(cfg_cls, **cfg_kw))
    h = svc.open(blob, KEY)
    flat = h.restore_tree(policy=pol_cls(mode="streamed", parallelism=2,
                                         **policy_kw))
    svc.close()
    return flat, h.reader.last_batch


def test_eager_flush_fires_and_stays_identical(tmp_path):
    """A slow origin and one giant tile: plain streaming decodes in ONE
    post-fetch tile, eager flush decodes partial tiles during fetch
    stalls (more tiles, same bytes), in both packages; the counter
    moves by the stats' count."""
    store_dir, tree, blob = _image(tmp_path, 12, seed=4)
    flat_plain, lb_plain = _restore("port", store_dir, blob,
                                    {"eager_flush": False})
    before = COUNTERS.get("decode.eager_flushes")
    flat_eager, lb_eager = _restore("port", store_dir, blob,
                                    {"eager_flush": True})
    jflat, jlb = _restore("jax", store_dir, blob, {"eager_flush": True})
    for flat in (flat_plain, flat_eager):
        assert np.array_equal(flat["w"], tree["w"])
        assert np.array_equal(flat["w"], np.asarray(jflat["w"]))
    assert lb_plain["eager_flushes"] == 0
    assert lb_eager["eager_flushes"] >= 1 and jlb["eager_flushes"] >= 1
    assert lb_eager["decode_tiles"] > lb_plain["decode_tiles"] == 1
    assert COUNTERS.get("decode.eager_flushes") - before == \
        lb_eager["eager_flushes"]
    # tri-state: an explicit eager_flush=False overrides an eager
    # service default (None inherits it)
    svc = ImageService(ChunkStore(store_dir), _slow_cfg(
        ServiceConfig, default_policy=ReadPolicy(eager_flush=True)))
    h = svc.open(blob, KEY)
    assert h._resolve(None)[1].eager_flush is True
    assert h._resolve(ReadPolicy(eager_flush=False))[1].eager_flush is False
    h.restore_tree(policy=ReadPolicy(mode="streamed", parallelism=2,
                                     eager_flush=False))
    assert h.reader.last_batch["eager_flushes"] == 0


def test_eager_min_bytes_holds_small_partials(tmp_path):
    """A threshold above the image holds every idle-queue flush
    (``eager_holds``) and keeps one tile; a zero threshold flushes on
    any idle queue, as in the JAX package."""
    store_dir, tree, blob = _image(tmp_path, 8, seed=6)
    lb = {}
    for pkg in ("port", "jax"):
        for thr in (1 << 30, 0):
            flat, lb[pkg, thr] = _restore(pkg, store_dir, blob,
                                          {"eager_flush": True},
                                          eager_min_bytes=thr)
            assert np.array_equal(np.asarray(flat["w"]), tree["w"])
    for pkg in ("port", "jax"):
        hold, zero = lb[pkg, 1 << 30], lb[pkg, 0]
        assert hold["eager_flushes"] == 0 and hold["eager_holds"] >= 1
        assert hold["decode_tiles"] == 1
        assert zero["eager_flushes"] >= 1 and zero["decode_tiles"] > 1


def test_session_ttl_expires_idle_handles(tmp_path):
    store_dir, tree, blob = _image(tmp_path, 2, seed=11)
    svc = ImageService(ChunkStore(store_dir), ServiceConfig(
        device="cpu", l1_bytes=8 << 20, l2_nodes=0, fetch_concurrency=0,
        max_coldstarts=0, decode_backend="python", session_ttl_s=0.05))
    before = COUNTERS.get("service.session_evictions")
    h1 = svc.open(blob, KEY)
    assert svc.open(blob, KEY).reader is h1.reader      # within the TTL
    time.sleep(0.08)
    h2 = svc.open(blob, KEY)                            # expired
    assert h2.reader is not h1.reader
    assert COUNTERS.get("service.session_evictions") - before >= 1
    # the expired handle keeps working (it owns its reader)
    assert np.array_equal(h1.restore_tree()["w"], tree["w"])
    # without a TTL the session stays
    svc = ImageService(ChunkStore(store_dir), ServiceConfig(
        device="cpu", l2_nodes=0, decode_backend="python"))
    h1 = svc.open(blob, KEY)
    time.sleep(0.08)
    assert svc.open(blob, KEY).reader is h1.reader


def test_policy_fields_and_decoder_pool_key(tmp_path):
    """The reference's names and defaults, and one pooled decoder per
    (canonical backend, tile, eager, eager_min_bytes)."""
    for f in ("max_batch_bytes", "eager_flush", "eager_min_bytes"):
        assert getattr(ReadPolicy(), f) is None is getattr(JPolicy(), f)
    cfg, jcfg = ServiceConfig(device="cpu"), JConfig()
    for f in ("decode_threads", "max_batch_bytes", "eager_min_bytes",
              "session_ttl_s", "session_cap", "manifest_cap"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert dec.DEFAULT_EAGER_MIN_BYTES == jdec.DEFAULT_EAGER_MIN_BYTES
    assert dec._TILE_CANDIDATES == jdec._TILE_CANDIDATES
    assert dec._REGISTRY["python"].tile_candidates == jdec._TILE_CANDIDATES
    svc = ImageService(ChunkStore(tmp_path), ServiceConfig(
        device="cpu", decode_backend="python", max_batch_bytes=1 << 16,
        decode_threads=2))
    d = svc.decoder_for(ReadPolicy())
    assert svc.decoder_for(ReadPolicy(decode_backend="numpy")) is d
    assert d.threads == 2 and d.max_batch_bytes == 1 << 16
    assert not d.eager_flush
    e = svc.decoder_for(ReadPolicy(eager_flush=True))
    assert e is not d and e.eager_flush
    m = svc.decoder_for(ReadPolicy(eager_flush=True, eager_min_bytes=0))
    assert m is not e and m.eager_min_bytes == 0
    t = svc.decoder_for(ReadPolicy(max_batch_bytes=8192))
    assert t is not d and t.max_batch_bytes == 8192
    svc.close()


# ------------------------------------------------------------- autotune

class _FakeHook:
    """A fused hook that counts calls; odd calls are the sweep's
    warmups, even ones its timed runs."""

    def __init__(self, warmup_sleep=0.0, timed_sleep=0.0, gate=None):
        self.calls = 0
        self.warmup_sleep = warmup_sleep
        self.timed_sleep = timed_sleep
        self.gate = gate
        self._lock = threading.Lock()

    def __call__(self, cts, keys):
        with self._lock:
            self.calls += 1
            n = self.calls
        if self.gate is not None:
            self.gate.wait(10)
        time.sleep(self.warmup_sleep if n % 2 else self.timed_sleep)
        return [b"\x00" * 32] * len(cts), [b""] * len(cts)


@pytest.fixture
def autotune_env(monkeypatch):
    """Registers fake CPU backends; restores the autotune state after."""
    monkeypatch.delenv("REPRO_NO_AUTOTUNE", raising=False)
    saved = dict(dec._AUTOTUNE_CACHE)
    added = []

    def register(name, hook, tile=64 << 10):
        b = dec.DecodeBackend(name, "test", tile_bytes=tile)
        b._hooks["cpu"] = (None, None, hook)
        dec._REGISTRY[name] = b
        added.append(name)
        return b

    yield register
    for name in added:
        dec._REGISTRY.pop(name, None)
        dec._AUTOTUNE_PENDING.pop((name, "cpu"), None)
        dec.AUTOTUNE_RATES.pop((name, "cpu"), None)
    dec._AUTOTUNE_CACHE.clear()
    dec._AUTOTUNE_CACHE.update(saved)


N_CANDS = 1 + sum(c != (64 << 10) for c in dec._TILE_CANDIDATES)


def test_autotune_warmup_untimed_and_unbudgeted(autotune_env):
    """Every candidate gets a warmup and a timed call; slow warmups
    (compile stand-ins) do not burn the budget."""
    hook = _FakeHook(warmup_sleep=0.03)
    autotune_env("t-warm", hook)
    # if warmups counted, the sweep would stop after candidate 1
    dec.autotune_tile_bytes("t-warm", device="cpu", budget_s=0.01)
    assert hook.calls == 2 * N_CANDS
    assert len(dec.AUTOTUNE_RATES["t-warm", "cpu"]) == N_CANDS


def test_autotune_budget_stops_timed_runs(autotune_env):
    """A candidate whose predecessors spent the budget never starts,
    not even its warmup."""
    hook = _FakeHook(timed_sleep=0.05)
    autotune_env("t-budget", hook)
    dec.autotune_tile_bytes("t-budget", device="cpu", budget_s=0.01)
    assert hook.calls == 2                  # candidate 1 only


def test_autotune_sweep_does_not_block_other_backends(autotune_env):
    """While one backend's sweep is stalled another backend tunes;
    concurrent callers of one backend share ONE sweep."""
    gate = threading.Event()
    slow, fast = _FakeHook(gate=gate), _FakeHook()
    autotune_env("t-slow", slow)
    autotune_env("t-fast", fast)
    results = {}

    def tune(name):
        results[name] = dec.autotune_tile_bytes(name, device="cpu",
                                                budget_s=0.01)

    stalled = [threading.Thread(target=tune, args=("t-slow",))
               for _ in range(3)]
    for t in stalled:
        t.start()
    deadline = time.time() + 5
    while slow.calls == 0 and time.time() < deadline:
        time.sleep(0.002)
    assert slow.calls == 1                  # one sweep despite 3 callers
    t0 = time.time()
    tune("t-fast")
    assert time.time() - t0 < 2
    assert fast.calls >= 2
    gate.set()
    for t in stalled:
        t.join(10)
    assert slow.calls >= 2
    assert results["t-slow"] > 0


def test_autotune_cache_force_env_and_explicit_tiles(autotune_env,
                                                     monkeypatch):
    """One sweep per backend and device per process (the counter ticks
    once), ``force`` re-measures, ``REPRO_NO_AUTOTUNE`` and the CPU for
    the kernel backends keep the registered tile, an explicit int
    always wins and ``"auto"`` takes the tuned tile."""
    hook = _FakeHook()
    autotune_env("t-cache", hook, tile=128 << 10)
    before = COUNTERS.get("decode.autotuned_backends")
    best = dec.autotune_tile_bytes("t-cache", device="cpu")
    assert best in dec._TILE_CANDIDATES
    calls = hook.calls
    assert calls == 2 * N_CANDS
    assert dec.autotune_tile_bytes("t-cache", device="cpu") == best
    d = dec.BatchDecoder("t-cache", max_batch_bytes="auto", device="cpu")
    assert d.max_batch_bytes == best and hook.calls == calls
    assert COUNTERS.get("decode.autotuned_backends") - before == 1
    dec.autotune_tile_bytes("t-cache", device="cpu", force=True)
    assert hook.calls == 2 * calls
    d = dec.BatchDecoder("t-cache", max_batch_bytes=12345, device="cpu")
    assert d.max_batch_bytes == 12345 and hook.calls == 2 * calls
    d = dec.BatchDecoder("t-cache", device="cpu")        # None: registered
    assert d.max_batch_bytes == 128 << 10
    # the env switch: no sweep, the registered tile
    other = _FakeHook()
    autotune_env("t-env", other, tile=256 << 10)
    monkeypatch.setenv("REPRO_NO_AUTOTUNE", "1")
    assert dec.autotune_tile_bytes("t-env", device="cpu") == 256 << 10
    assert other.calls == 0
    monkeypatch.delenv("REPRO_NO_AUTOTUNE")
    # the kernel backends keep their tile on the CPU, with no sweep
    for name in ("torch-fused", "fused", "torch", "auto"):
        assert dec.autotune_tile_bytes(name, device="cpu") == \
            dec.KERNEL_TILE_BYTES
    assert ("torch-fused", "cpu") not in dec._AUTOTUNE_CACHE
    assert dec._REGISTRY["torch-fused"].tile_candidates == \
        dec.KERNEL_TILE_CANDIDATES
