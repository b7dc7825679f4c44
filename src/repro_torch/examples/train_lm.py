"""End-to-end training driver: a ~100M-parameter llama-style LM trained
for a few hundred steps on the synthetic pipeline, with async
chunk-store checkpoints, a simulated crash half way, and a resume in a
new trainer (the port of the JAX round's ``examples/train_lm.py``).

The config is the JAX example's: SmolLM-360M's family cut to 16 layers,
d_model 576, 8/4 heads of 72, d_ff 1536, vocab 49152, tied embeddings;
``LoopConfig(batch=4, seq=128, ckpt_every=50)``, ``OptConfig(lr=6e-4)``.
``--quick`` takes the JAX example's tiny config and 30 steps.

Checkpoints publish through an ``ImageService`` (the SHA-256 and AES
kernels on the card). The resumed trainer is a new ``Trainer`` with a
new ``CheckpointManager`` and service on the same store, as a
restarted process would be: it discovers the newest checkpoint and
restores it through the fused verify+decrypt kernel. Every step's loss
is kept (``log_every=1``); the lines printed keep the JAX example's
cadence.

Run: PYTHONPATH=src python -m repro_torch.examples.train_lm
     [--steps N] [--quick] [--device cuda|cpu] [--store DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time

from repro_torch.examples import DEVICES, backend_for

TENANT_KEY = b"t" * 32
LEARNING_DROP = 0.2      # the JAX example's "LEARNING" test


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_lm",
        description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="steps in all (default 300, or 30 with --quick)")
    ap.add_argument("--quick", action="store_true", help="tiny config/steps")
    ap.add_argument("--device", default="cuda", choices=DEVICES)
    ap.add_argument("--store", default=None,
                    help="chunk-store dir (default: a temporary one, "
                         "removed at exit)")
    return ap


def config(quick: bool, steps: int | None) -> tuple:
    """(model config, LoopConfig, the JAX example's print cadence)."""
    from repro_torch.configs import get_config
    from repro_torch.train.loop import LoopConfig
    from repro_torch.train.optimizer import OptConfig

    if quick:
        cfg = get_config("smollm-360m").reduced()
        return cfg, LoopConfig(steps=steps or 30, batch=4, seq=64,
                               ckpt_every=10,
                               log_every=1, opt=OptConfig(lr=1e-3)), 5
    # ~100M params: d_model=576, 16L, tied embeddings
    cfg = get_config("smollm-360m").reduced(
        num_layers=16, d_model=576, num_heads=8, num_kv_heads=4,
        head_dim=72, d_ff=1536, vocab_size=49152)
    return cfg, LoopConfig(steps=steps or 300, batch=4, seq=128,
                           ckpt_every=50,
                           log_every=1, opt=OptConfig(lr=6e-4)), 10


def _print_losses(history: list, every: int, last: int):
    for h in history:
        if h["step"] % every == 0 or h["step"] == last:
            print(f"   step {h['step']:4d} loss {h['loss']:.4f}")


def main(argv=None) -> dict:
    """Train, crash, resume, finish; returns every figure printed: the
    parameter counts, each step's loss of both trainers, the crash and
    resume steps and each checkpoint's stats."""
    args = build_parser().parse_args(argv)

    from repro_torch.core.gc import GenerationalGC, RefcountIndex, \
        RootPinRegistry
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    from repro_torch.launch.modelflops import param_counts
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.loop import Trainer

    cfg, loop, every = config(args.quick, args.steps)
    backend = backend_for(args.device)
    out = {"config": cfg.name, "steps": loop.steps, "batch": loop.batch,
           "seq": loop.seq, "ckpt_every": loop.ckpt_every}
    with contextlib.ExitStack() as stack:
        store = ChunkStore(args.store or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro-train-")))
        pins, refs = RootPinRegistry(), RefcountIndex()
        gc = GenerationalGC(store, pins=pins, refcounts=refs)

        def manager():
            # a trainer process's own service: no L1 (it publishes, and a
            # restarted process restores from the origin)
            svc = ImageService(store, ServiceConfig(
                device=args.device, decode_backend=backend, l1_bytes=0),
                pins=pins, refcounts=refs)
            stack.callback(svc.close)
            return svc, CheckpointManager(
                store, gc, tenant="train-run", tenant_key=TENANT_KEY,
                run_name="lm100m", service=svc, device=args.device)

        svc, ck = manager()
        tr = Trainer(cfg, loop, ckpt_mgr=ck, device=args.device).init()
        pc = param_counts(cfg, tr.model.param_shapes())
        out["param_counts"] = pc
        print(f"model: {pc['total_with_embed'] / 1e6:.1f}M params "
              f"({pc['total'] / 1e6:.1f}M non-embedding)")

        half = loop.steps // 2
        t0 = time.time()
        tr.run(half)
        out["crash_step"] = tr.step
        out["s_per_step_a"] = (time.time() - t0) / max(tr.step, 1)
        print(f"-- simulated crash at step {tr.step} "
              f"({out['s_per_step_a']:.2f}s/step) --")
        _print_losses(tr.history, every, tr.step)
        svc.close()

        # a NEW trainer process resumes from the chunk store
        _, ck2 = manager()
        t0 = time.time()
        tr2 = Trainer(cfg, loop, ckpt_mgr=ck2, device=args.device).resume()
        out["resume_s"] = time.time() - t0
        out["resumed_step"] = tr2.step
        print(f"resumed from checkpoint at step {tr2.step}")
        t0 = time.time()
        tr2.run(loop.steps - tr2.step)
        out["s_per_step_b"] = (time.time() - t0) / max(
            loop.steps - out["resumed_step"], 1)
        _print_losses(tr2.history, every, tr2.step)
        out["losses_a"] = [(h["step"], h["loss"]) for h in tr.history]
        out["losses_b"] = [(h["step"], h["loss"]) for h in tr2.history]
        out["step_s_a"] = [h["s"] for h in tr.history]
        out["step_s_b"] = [h["s"] for h in tr2.history]
        # the first loss the JAX example logs (its log_every)
        first = next(h["loss"] for h in tr.history
                     if h["step"] % every == 0 or h["step"] == tr.step)
        last = tr2.history[-1]["loss"]
        out["learning"] = last < first - LEARNING_DROP
        out.update(first_loss=first, last_loss=last)
        print(f"loss {first:.3f} -> {last:.3f} "
              f"({'LEARNING' if out['learning'] else 'check hyperparams'})")
        out["checkpoints"] = []
        for rec in ck.records + ck2.records:
            s = rec.stats
            out["checkpoints"].append({"step": rec.step, **s})
            print(f"   ckpt@{rec.step}: unique={s['unique_chunks']} "
                  f"dedup={s['dedup_chunks']} "
                  f"uploaded={s['bytes_uploaded'] / 1e6:.0f}MB "
                  f"async={s['seconds']:.1f}s")
    return out


if __name__ == "__main__":
    main()
