#!/usr/bin/env python3
"""Where a training step's time goes on the GPU.

    PYTHONPATH=src python3 scripts/profile_train_step.py \
        [--arch smollm-360m] [--variant baseline] [--batch 8] [--seq 512] \
        [--steps 3] [--trace build/train_step.json]

Builds a ``repro_torch.train.loop.Trainer`` at the config's full width
(weights drawn on the card from ``--seed``), runs two warm-up steps,
then ``--steps`` steps under ``torch.profiler`` (CPU and CUDA
activities), after the same number of steps without the profiler.
Prints the card's name and power limit, each step's wall time,
unprofiled and profiled (host clock, each step ends in a device sync:
the loss is read), the device's busy time (the union of its kernels'
intervals) as a share of the profiled steps' wall time and of the
median unprofiled step (the profiler slows the host, not the
kernels), and the kernels
that took the most device time, by name, with counts, and grouped by
name as matmuls, attention, reductions, copies and casts, and other
elementwise work.
``--trace`` writes the Chrome trace. Needs a CUDA device; exits 2
without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

GROUPS = (("matmul", ("gemm", "cutlass", "sm90_xmma", "cublas", "nvjet")),
          ("attention", ("fmha", "flash", "attention", "softmax")),
          ("reduce", ("reduce",)),
          ("copy/cast", ("copy", "cast", "convert")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise/other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.variants import get_variant
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.optimizer import OptConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print("card:", smi[0] if smi else "unavailable")
    cfg = get_config(args.arch)
    _, flags, opt = get_variant(args.variant, cfg, SHAPES["train_4k"])
    loop = LoopConfig(steps=1, batch=args.batch, seq=args.seq,
                      ckpt_every=1 << 30, log_every=1, seed=args.seed,
                      opt=OptConfig(**opt))
    tr = Trainer(cfg, loop, flags=flags, device="cuda").init()
    tr.run(2)
    tr.run(args.steps)                  # the same steps without the profiler
    torch.cuda.synchronize()
    plain_ms = [1e3 * h["s"] for h in tr.history[-args.steps:]]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the window holds the steps alone: not the profiler's start-up,
        # nor its teardown and event collection at the block's exit
        t0 = time.perf_counter()
        tr.run(args.steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps_ms = [1e3 * h["s"] for h in tr.history[-args.steps:]]
    tokens_per_s = args.batch * args.seq * args.steps / wall_us * 1e6
    plain_med = sorted(plain_ms)[len(plain_ms) // 2]
    print(f"{cfg.name} [{args.variant}] B={args.batch} S={args.seq}: "
          f"steps {', '.join(f'{s:.2f}' for s in plain_ms)} ms unprofiled "
          f"(median {plain_med:.2f} ms, tokens/s "
          f"{args.batch * args.seq / plain_med * 1e3:.0f}); "
          f"{', '.join(f'{s:.2f}' for s in steps_ms)} ms profiled "
          f"(tokens/s {tokens_per_s:.0f})")

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("the profiler recorded no device time")
        return 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    busy_ms = busy / 1e3 / args.steps
    print(f"device busy {busy / 1e3:.2f} ms of a {wall_us / 1e3:.2f} ms "
          f"profiled window ({busy / wall_us:.1%}; idle "
          f"{1 - busy / wall_us:.1%}); first to last kernel "
          f"{window / 1e3:.2f} ms; {busy_ms:.2f} ms a step is "
          f"{busy_ms / plain_med:.1%} of the unprofiled median step (idle "
          f"{1 - busy_ms / plain_med:.1%})")
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    total = sum(t for t, _ in by_name.values())
    groups: dict = {}
    for name, (t, n) in by_name.items():
        g = group_of(name)
        gt, gn = groups.get(g, (0.0, 0))
        groups[g] = (gt + t, gn + n)
    print("by group (device ms per step, launches per step, share):")
    for g, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:18s} {t / 1e3 / args.steps:9.2f} {n / args.steps:8.0f}"
              f"  {t / total:6.1%}")
    print(f"top {args.top} kernels (device ms per step, launches per step):")
    for name, (t, n) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][0])[:args.top]:
        print(f"  {t / 1e3 / args.steps:9.2f} {n / args.steps:6.0f}  "
              f"{name[:110]}")
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print("trace:", args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
