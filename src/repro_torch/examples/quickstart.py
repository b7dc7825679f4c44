"""Quickstart: the paper's pipeline end to end on SmolLM-360M (the port
of the JAX round's ``examples/quickstart.py``).

  weights -> deterministic flatten -> 512 KiB chunks -> convergent
  encrypt -> dedup'd PUT -> sealed manifest -> demand-paged restore
  (including a shard-only restore) -> GC root cycle.

The model runs at full width and depth (32 layers, a 1.449 GB image of
2763 chunks of 512 KiB); ``--reduced`` takes the CPU-sized config, and
``--chunk-size 65536`` the JAX example's chunk. Publishes go through
an ``ImageService`` (the SHA-256 and AES kernels on the card) and
restores through a second service with no cache of its own (the fused
verify+decrypt kernel), so every chunk a restore touches comes from the
origin, as the JAX example's ``ImageReader`` reads it.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart
     [--device cuda|cpu] [--reduced] [--chunk-size N] [--store DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import tempfile

import numpy as np

from repro_torch.examples import DEVICES, backend_for

BASE_KEY = b"q" * 32
FT_KEY = b"z" * 32


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=DEVICES)
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-sized reduced config")
    ap.add_argument("--chunk-size", type=int, default=512 * 1024)
    ap.add_argument("--store", default=None,
                    help="chunk-store dir (default: a temporary one, "
                         "removed at exit)")
    return ap


def main(argv=None, *, weights: dict | None = None) -> dict:
    """Run the quickstart; `weights` (a flat {path: array} tree, e.g.
    another package's init) replaces the weights drawn from seed 0.
    Returns every figure printed, and each restore's SHA-256."""
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.gc import GenerationalGC, RefcountIndex, \
        RootPinRegistry
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    from repro_torch.models import build_model, init_flat
    from repro_torch.models.lm import RunFlags
    from repro_torch.train.checkpoint import state_to_tree

    out = {}
    cfg = get_config("smollm-360m")
    if args.reduced:
        cfg = cfg.reduced()
    print(f"== 1. build a model checkpoint ({cfg.name}) ==")
    model = build_model(cfg, RunFlags(dtype="float32"), device=args.device)
    model.load_flat(weights if weights is not None
                    else init_flat(cfg, 0))
    tree = state_to_tree(model.params)
    del model
    nbytes = sum(v.nbytes for v in tree.values())
    out.update(tensors=len(tree), bytes=nbytes)
    print(f"   {len(tree)} tensors, {nbytes / 1e6:.1f} MB")

    backend = backend_for(args.device)
    with contextlib.ExitStack() as stack:
        store = ChunkStore(args.store or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro-quickstart-")))
        pins, refs = RootPinRegistry(), RefcountIndex()
        svc = ImageService(store, ServiceConfig(
            device=args.device, decode_backend=backend),
            pins=pins, refcounts=refs)
        stack.callback(svc.close)
        gc = GenerationalGC(store, pipeline=svc.publisher(), pins=pins,
                            refcounts=refs)
        # a worker that published nothing: every chunk from the origin
        reader = ImageService(store, ServiceConfig(
            device=args.device, decode_backend=backend, l1_bytes=0,
            max_coldstarts=0), pins=pins)
        stack.callback(reader.close)

        print("== 2. create the base image (flatten+chunk+encrypt+upload) ==")
        blob, stats = svc.publish(tree, tenant="base-team",
                                  tenant_key=BASE_KEY, root=gc.active,
                                  chunk_size=args.chunk_size)
        out["base"] = _stats(stats)
        print(f"   chunks={stats.total_chunks} zero={stats.zero_chunks} "
              f"unique={stats.unique_chunks} "
              f"uploaded={stats.bytes_uploaded / 1e6:.1f}MB")

        print("== 3. a fine-tune that only touches the first group ==")
        ft = dict(tree)
        name = next(k for k in ft if k.startswith("g0"))
        ft[name] = ft[name] + np.float32(0.01)
        blob_ft, s_ft = svc.publish(ft, tenant="ft-team", tenant_key=FT_KEY,
                                    root=gc.active,
                                    chunk_size=args.chunk_size)
        out["fine_tune"] = _stats(s_ft)
        out["fine_tune"]["unique_fraction"] = s_ft.unique_fraction
        out["tensor"] = name
        print(f"   fine-tune unique={s_ft.unique_chunks} "
              f"dedup={s_ft.dedup_chunks} ({s_ft.unique_fraction:.1%} "
              f"unique -> paper Fig 5 territory)")

        print("== 4. demand restore: one tensor, then a half shard ==")
        h = reader.open(blob_ft, FT_KEY)
        t = h.restore_tree([name])[name]
        out["tensor_sha256"] = sha(t)
        out["tensor_ok"] = bool(np.array_equal(t, ft[name]))
        print(f"   tensor {name}: {tuple(t.shape)} ok={out['tensor_ok']}")
        del t
        emb = h.layout.tensors["embed"]
        half_sl = [(0, emb.shape[0] // 2), (0, emb.shape[1])]
        half = h.tensor_shard("embed", half_sl)
        touched = len(h.shard_chunks({"embed": half_sl}))
        out.update(half_shape=list(half.shape), half_sha256=sha(half),
                   half_ok=bool(np.array_equal(
                       half, tree["embed"][:emb.shape[0] // 2])),
                   chunks_touched=touched, num_chunks=h.layout.num_chunks)
        print(f"   embed half-shard: {tuple(half.shape)}, chunks touched="
              f"{touched}/{h.layout.num_chunks}")
        del half

        print("== 5. GC: new root, migrate live images, expire the old ==")
        old = gc.active
        gc.new_root()
        gc.migrate(old, live_images={stats.image_id, s_ft.image_id})
        gc.expire(old)
        ok = gc.delete_expired(old)
        out.update(migrated_manifests=gc.stats.migrated_manifests,
                   migrated_chunks=gc.stats.migrated_chunks,
                   deleted_old_root=ok)
        print(f"   migrated {gc.stats.migrated_manifests} manifests, "
              f"{gc.stats.migrated_chunks} chunks; deleted old root: {ok}")
        h2 = reader.open(store.get_manifest(gc.active, s_ft.image_id),
                         FT_KEY, root=gc.active)
        t2 = h2.restore_tree([name])[name]
        out["restore_after_gc_sha256"] = sha(t2)
        out["restore_after_gc_ok"] = bool(np.array_equal(t2, ft[name]))
        print(f"   restore-after-gc ok: {out['restore_after_gc_ok']}")
    return out


def _stats(s) -> dict:
    return {"image_id": s.image_id, "total_chunks": s.total_chunks,
            "zero_chunks": s.zero_chunks, "unique_chunks": s.unique_chunks,
            "dedup_chunks": s.dedup_chunks, "bytes_total": s.bytes_total,
            "bytes_uploaded": s.bytes_uploaded}


if __name__ == "__main__":
    main()
