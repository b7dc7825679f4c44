"""The port's examples (``repro_torch.examples``) against the JAX
round's ``examples/*.py`` on the CPU, at small size: each port example
runs through its ``main(argv)`` with ``--device cpu``, and the JAX
example's library calls run through ``repro`` on the same inputs.

Weights are the JAX ``init`` params carried across by
``DecoderLM.load_flat`` (``main(..., weights=...)``); population data
and traces come from numpy seeds. Counts and bytes must be equal, and
greedy tokens equal at float32."""
import hashlib

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jconfig  # noqa: E402
from repro.core.gc import GenerationalGC as JGC  # noqa: E402
from repro.core.loader import ImageReader as JReader  # noqa: E402
from repro.core.loader import create_image as jcreate  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.train.checkpoint import state_to_tree as jtree  # noqa: E402


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _jax_params(seed=0):
    cfg = jconfig("smollm-360m").reduced()
    model = jbuild(cfg)
    return model, jtree(model.init(jax.random.key(seed)))


def _stats(s) -> dict:
    return {"image_id": s.image_id, "total_chunks": s.total_chunks,
            "zero_chunks": s.zero_chunks, "unique_chunks": s.unique_chunks,
            "dedup_chunks": s.dedup_chunks, "bytes_total": s.bytes_total,
            "bytes_uploaded": s.bytes_uploaded}


# --------------------------------------------------------------- quickstart

def _jax_quickstart(tree, store_dir) -> dict:
    """The JAX example's five steps (``examples/quickstart.py``)."""
    out = {}
    store = JStore(store_dir)
    gc = JGC(store)
    blob, stats = jcreate(tree, tenant="base-team", tenant_key=b"q" * 32,
                          store=store, root=gc.active, chunk_size=65536)
    out["base"] = _stats(stats)
    ft = dict(tree)
    name = next(k for k in ft if k.startswith("g0"))
    ft[name] = ft[name] + 0.01
    blob_ft, s_ft = jcreate(ft, tenant="ft-team", tenant_key=b"z" * 32,
                            store=store, root=gc.active, chunk_size=65536)
    out["fine_tune"] = _stats(s_ft)
    out["tensor"] = name
    r = JReader(blob_ft, b"z" * 32, store)
    out["tensor_sha256"] = _sha(r.tensor(name))
    emb = r.layout.tensors["embed"]
    sl = [(0, emb.shape[0] // 2), (0, emb.shape[1])]
    half = r.tensor_shard("embed", sl)
    out.update(half_shape=list(half.shape), half_sha256=_sha(half),
               chunks_touched=len(r.shard_chunks({"embed": sl})),
               num_chunks=r.layout.num_chunks)
    old = gc.active
    gc.new_root()
    gc.migrate(old, live_images={stats.image_id, s_ft.image_id})
    gc.expire(old)
    out["deleted_old_root"] = gc.delete_expired(old)
    out["migrated_manifests"] = gc.stats.migrated_manifests
    out["migrated_chunks"] = gc.stats.migrated_chunks
    r2 = JReader(store.get_manifest(gc.active, s_ft.image_id), b"z" * 32,
                 store, root=gc.active)
    out["restore_after_gc_sha256"] = _sha(r2.tensor(name))
    return out, store, gc.active


def test_quickstart_matches_the_jax_example(tmp_path):
    from repro_torch.core.store import ChunkStore
    from repro_torch.examples import quickstart

    _, tree = _jax_params()
    want, jstore, jroot = _jax_quickstart(tree, tmp_path / "jax")
    got = quickstart.main(["--device", "cpu", "--reduced", "--chunk-size",
                           "65536", "--store", str(tmp_path / "port")],
                          weights=tree)
    assert got["fine_tune"].pop("unique_fraction") == pytest.approx(
        want["fine_tune"]["unique_chunks"]
        / (want["fine_tune"]["total_chunks"]
           - want["fine_tune"]["zero_chunks"]))
    for k, v in want.items():
        assert got[k] == v, k
    assert got["tensor_ok"] and got["half_ok"] and got["restore_after_gc_ok"]
    assert got["tensors"] == len(tree)
    assert got["bytes"] == sum(v.nbytes for v in tree.values())
    # the same chunks, byte for byte, in the surviving root
    pstore = ChunkStore(tmp_path / "port")
    names = sorted(jstore.list_chunks(jroot))
    assert sorted(pstore.list_chunks(jroot)) == names and names
    for n in names[:4]:
        assert pstore.get_chunk(jroot, n) == jstore.get_chunk(jroot, n)
    assert pstore.list_roots() == jstore.list_roots()


# ---------------------------------------------------------- serve_finetunes

def test_serve_finetunes_matches_the_jax_example(tmp_path):
    """Three fine-tunes (no node fails before the fourth start): each
    replica's origin fetches, scoped L1 hits and float32 tokens, and the
    fleet's upload and dedup counts, equal the JAX example's run of the
    same calls (``examples/serve_finetunes.py``)."""
    from repro.core.cache.distributed import DistributedCache as JL2
    from repro.core.service import ImageService as JService
    from repro.core.service import ServiceConfig as JConfig
    from repro.core.telemetry import COUNTERS as JCOUNTERS
    from repro.models.lm import RunFlags as JFlags
    from repro.serve.coldstart import cold_start as jcold_start
    from repro.serve.engine import Request as JRequest
    from repro_torch.examples import serve_finetunes

    n = 3
    model, base = _jax_params()
    jmodel = jbuild(model.cfg, JFlags(dtype="float32"))
    store = JStore(tmp_path / "jax")
    gc = JGC(store)
    c0 = JCOUNTERS.snapshot()
    want_ft, blobs = [], []
    rng = np.random.default_rng(0)
    for i in range(n):
        ft = dict(base)
        victim = sorted(base)[i % len(base)]
        ft[victim] = ft[victim] + rng.standard_normal(
            ft[victim].shape).astype(ft[victim].dtype) * 0.01
        blob, s = jcreate(ft, tenant=f"team{i}",
                          tenant_key=b"%02d" % i * 16,
                          store=store, root=gc.active, chunk_size=65536,
                          image_id=f"ft{i}")
        blobs.append(blob)
        want_ft.append((victim, s.unique_chunks, s.dedup_chunks))
    uploaded = JCOUNTERS.get("store.chunks_uploaded") \
        - c0.get("store.chunks_uploaded", 0)
    dedup = JCOUNTERS.get("store.dedup_hits") - c0.get("store.dedup_hits", 0)
    l2 = JL2(num_nodes=6, seed=1)
    service = JService(store, JConfig(l1_bytes=64 << 20, max_coldstarts=4,
                                      fetch_concurrency=16), l2=l2)
    want = []
    for i, blob in enumerate(blobs):
        scoped = service.tenant_counters(f"team{i}")
        h0 = scoped.get("read.l1_hits")
        eng, stats = jcold_start(jmodel, blob, b"%02d" % i * 16, service,
                                 max_batch=2, max_len=32)
        req = JRequest(0, prompt=[11, 22, 33], max_new=4)
        eng.submit(req)
        eng.run_until_drained()
        want.append((stats["tenant"], stats["origin_fetches"],
                     scoped.get("read.l1_hits") - h0, list(req.out)))

    seen = []
    got = serve_finetunes.main(
        ["--device", "cpu", "--reduced", "--fine-tunes", str(n), "--dtype",
         "float32", "--chunk-size", "65536", "--l1-bytes", str(64 << 20)],
        weights=base,
        on_replica=lambda i, eng, stats, tree: seen.append(i))
    assert seen == list(range(n))
    assert [(f["tensor"], f["unique_chunks"], f["dedup_chunks"])
            for f in got["fine_tunes"]] == want_ft
    assert [(r["tenant"], r["origin_fetches"], r["l1_hits"], r["tokens"])
            for r in got["replicas"]] == want
    assert got["fleet"]["chunks_uploaded"] == uploaded
    assert got["fleet"]["dedup_hits"] == dedup
    assert got["fleet"]["origin_fetches"] == sum(w[1] for w in want)


# ---------------------------------------------------------- coldstart_drill

DRILL = dict(n_functions=8, n_bases=3, chunk_size=8192, base_shape=(64, 256))


def _jax_drill(store, root, l1_bytes) -> dict:
    """The JAX example's four phases (``examples/coldstart_drill.py``) at
    8 functions and 60 invocations a phase."""
    import sys
    from pathlib import Path

    from repro.core.cache.distributed import DistributedCache as JL2
    from repro.core.cache.local import LocalCache as JLocal
    from repro.core.concurrency import RejectingLimiter as JLimiter
    from repro.core.telemetry import COUNTERS as JCOUNTERS
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks.workload import build_population, zipf_trace

    pop = build_population(store, root, **DRILL)
    l1s = [JLocal(l1_bytes, name="l1") for _ in range(4)]
    l2 = JL2(num_nodes=6, seed=3)
    lim = JLimiter(8)
    out = {"images": [(s.image_id, s.total_chunks, s.unique_chunks,
                       s.dedup_chunks) for s in pop.stats]}
    names = ("l1.hits", "l1.misses", "read.origin_fetches")
    for name, seed in (("warmup", 1), ("steady", 2), ("cold restart", 4),
                       ("post-recovery", 5)):
        if name == "cold restart":
            l2.flush()
            for l1 in l1s:
                l1.lru.data.clear()
                l1.lru.used = 0
        c0 = {k: JCOUNTERS.get(k) for k in names}
        rejected = 0
        for _k, f in zipf_trace(8, 60, seed=seed):
            if not lim.try_acquire():
                rejected += 1
                continue
            try:
                r = JReader(pop.blobs[f % len(pop.blobs)], pop.tenant_key,
                            store, l1=l1s[f % len(l1s)], l2=l2)
                r.tensor("base/common")
            finally:
                lim.release()
        d = {k: JCOUNTERS.get(k) - c0[k] for k in names}
        reads = d["l1.hits"] + d["l1.misses"]
        out[name] = (reads, d["l1.hits"] / max(reads, 1),
                     d["read.origin_fetches"] / max(reads, 1), rejected)
    return out


def test_coldstart_drill_matches_the_jax_example(tmp_path):
    from repro_torch.core.store import ChunkStore
    from repro_torch.examples import coldstart_drill

    got = coldstart_drill.main([
        "--device", "cpu", "--functions", "8", "--invocations", "60",
        "--rows", "64", "--cols", "256", "--chunk-size", "8192",
        "--store", str(tmp_path / "port")])
    store = JStore(tmp_path / "jax")
    root = JGC(store).active
    want = _jax_drill(store, root, got["l1_bytes"])
    # the JAX example's 4 MiB L1 against its 768 KiB tensor
    assert got["l1_bytes"] == (4 << 20) * 64 * 256 * 4 // (384 * 512 * 4)
    # the population: same images, stats and chunk names
    assert [(s["image_id"], s["total_chunks"], s["unique_chunks"],
             s["dedup_chunks"]) for s in got["images"]] == want["images"]
    names = sorted(store.list_chunks(root))
    assert sorted(ChunkStore(tmp_path / "port").list_chunks(root)) == names
    for name in ("warmup", "steady", "cold restart", "post-recovery"):
        p = got["phases"][name]
        assert (p["reads"], p["l1_hit_rate"], p["origin_fraction"],
                p["rejected"]) == want[name], name
    assert want["warmup"][2] > 0 and want["cold restart"][2] > 0
    # the port's trace copy is the JAX one
    from benchmarks.workload import zipf_trace
    assert coldstart_drill.zipf_trace(24, 300, seed=4) == \
        zipf_trace(24, 300, seed=4)


# ----------------------------------------------------------------- train_lm

def test_train_lm_quick_resumes_bitwise(tmp_path):
    """``--quick`` at 20 steps: trainer A crashes after step 10 (its
    step-10 checkpoint published), a new trainer resumes at step 10,
    and its first loss (step 11) equals, bitwise, that of an
    uninterrupted trainer run to step 11."""
    from repro_torch.examples import train_lm
    from repro_torch.train.loop import Trainer

    got = train_lm.main(["--quick", "--steps", "20", "--device", "cpu",
                         "--store", str(tmp_path)])
    assert got["crash_step"] == 10 and got["resumed_step"] == 10
    assert [s for s, _ in got["losses_a"]] == list(range(1, 11))
    assert [s for s, _ in got["losses_b"]] == list(range(11, 21))
    assert [c["step"] for c in got["checkpoints"]] == [10, 20]
    cfg, loop, _ = train_lm.config(True, 20)
    ref = Trainer(cfg, loop, device="cpu").init()
    ref.run(11)
    want = [h["loss"] for h in ref.history]
    assert [x for _, x in got["losses_a"]] == want[:10]
    assert got["losses_b"][0][1] == want[10]
    assert got["param_counts"]["total_with_embed"] > 0
    assert all(np.isfinite(x) for _, x in got["losses_b"])


def test_train_lm_labels_follow_the_inputs_only_at_position_0():
    """Why train_lm's loss stays at ln(vocab) in both packages (chip_smoke
    phase 12 prints the JAX example's LEARNING verdict and does not
    require it): ``global_batch`` plants ``31 t + U{0..6} mod V`` from
    the tokens before it replaces them, so a label follows the model's
    input at position 0 only, and elsewhere at the chance rate 7 / V.
    The port's batches are the JAX package's, draw for draw."""
    from repro.data.synthetic import global_batch as jbatch
    from repro_torch.data.synthetic import global_batch
    from repro_torch.examples import train_lm

    cfg, loop, _ = train_lm.config(False, None)
    jcfg = jconfig("smollm-360m").reduced(
        num_layers=16, d_model=576, num_heads=8, num_kv_heads=4,
        head_dim=72, d_ff=1536, vocab_size=49152)
    assert jcfg.vocab_size == cfg.vocab_size == 49152
    for step in (0, 1, 149):
        b = global_batch(cfg, step, loop.batch, loop.seq, seed=loop.seed)
        jb = jbatch(jcfg, step, loop.batch, loop.seq, seed=loop.seed)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(np.asarray(b[k]),
                                          np.asarray(jb[k]))
        d = (b["labels"].astype(np.int64) - 31 * b["tokens"].astype(
            np.int64)) % cfg.vocab_size
        assert (d[:, 0] < 7).all()
        assert (d[:, 1:] < 7).mean() < 0.01
