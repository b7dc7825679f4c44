"""Production-style training launcher (the port of
``repro.launch.train``): one process, one device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 100 --batch 4 --seq 64 [--variant opt8bit] \\
      [--store /tmp/run-store] [--resume] [--device cuda|cpu]

Every flag of the JAX package's launcher is here under the same name
and default, except:

* ``--device`` (default ``cuda``) is added: the trainer's device, and
  that of the checkpoints' service;
* ``--perf-flags`` is not carried over: it sets XLA flags for TPU
  collectives.

Checkpoints publish through an ``ImageService`` wired to the GC (the
JAX launcher's manager uses the serial ``create_image``, whose
manifests and chunks are byte-identical): on the card its SHA-256 and
AES kernels, and ``--resume`` restores through the fused kernel; with
``--device cpu`` the service runs the host backend (``python``: numpy
AES and hashlib, the crypto ``create_image`` uses). A variant's sharding policy has no
effect on one device without a mesh (``launch.variants``). ``main(argv)``
prints the JAX launcher's lines and returns the trainer's history.
"""
from __future__ import annotations

import argparse
import tempfile

TENANT_KEY = b"L" * 32


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-sized reduced config")
    ap.add_argument("--store", default=None, help="chunk-store dir")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="the trainer's and the checkpoint service's "
                         "device (cpu: the plain versions, host crypto)")
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.gc import GenerationalGC
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    from repro_torch.launch.variants import get_variant
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    _policy, flags, opt_over = get_variant(args.variant, cfg,
                                           SHAPES["train_4k"])
    store = ChunkStore(args.store or tempfile.mkdtemp(prefix="repro-store-"))
    gc = GenerationalGC(store)
    backend = "python" if args.device == "cpu" else "torch-fused"
    service = ImageService(store, ServiceConfig(
        device=args.device, decode_backend=backend),
        pins=gc.pins, refcounts=gc.refcounts)
    ck = CheckpointManager(store, gc, tenant="launch", tenant_key=TENANT_KEY,
                           run_name=f"{args.arch}", service=service,
                           device=args.device)
    loop = LoopConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                      ckpt_every=args.ckpt_every, log_every=10,
                      opt=OptConfig(**opt_over))
    try:
        tr = Trainer(cfg, loop, ckpt_mgr=ck, flags=flags,
                     device=args.device)
        tr = tr.resume() if args.resume else tr.init()
        print(f"training {args.arch} [{args.variant}] from step {tr.step}")
        for h in tr.run():
            print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
                  f"gnorm {h['grad_norm']:.2f}  {h['s']:.2f}s")
        saved = [(r.step, r.stats.get("unique_chunks")) for r in ck.records]
        print(f"checkpoints: {saved}")
    finally:
        service.close()
    return tr.history


if __name__ == "__main__":
    main()
