"""Dry-run sweep driver (the port of ``repro.launch.sweep``): every
(arch x applicable shape x mesh) cell in a fresh subprocess (one bad
cell can't sink the sweep; each process makes its own fake process
group). Results land in results/dryrun_torch/*.json, with a
``sweep_<variant>.json`` summary.

Usage: PYTHONPATH=src python -m repro_torch.launch.sweep
       [--multi-pod-only|--single-pod-only] [--variant baseline]
       [--arch A] [--jobs N] [--device cuda|cpu]

``--device`` (default ``cuda``) is passed on to every cell's dry run;
without a card each cell raises unless it is ``cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.configs import applicable_shapes, get_config, list_archs
from repro_torch.launch.dryrun import RESULTS_DIR

REPO = Path(__file__).resolve().parents[3]


def run_one(arch: str, shape: str, multi_pod: bool, variant: str,
            force: bool = False, device: str = "cuda") -> dict:
    mesh = "2x16x16" if multi_pod else "16x16"
    out = RESULTS_DIR / f"{arch}_{shape}_{mesh}_{variant}.json"
    if out.exists() and not force:
        return {"arch": arch, "shape": shape, "mesh": mesh, "cached": True,
                "ok": True}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--variant", variant, "--device", device]
    if multi_pod:
        cmd.append("--multi-pod")
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          cwd=REPO, env={**os.environ, "PYTHONPATH": "src"},
                          timeout=3600)
    ok = proc.returncode == 0 and out.exists()
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "variant": variant,
           "ok": ok, "wall_s": round(time.time() - t0, 1)}
    if not ok:
        rec["stderr"] = proc.stderr[-2000:]
        print(f"FAIL {arch} x {shape} [{mesh}]\n{proc.stderr[-1500:]}")
    else:
        print(f"ok   {arch} x {shape} [{mesh}] {rec['wall_s']}s")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cells = []
    for arch in ([args.arch] if args.arch else list_archs()):
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            if not args.multi_pod_only:
                cells.append((arch, shape.name, False))
            if not args.single_pod_only:
                cells.append((arch, shape.name, True))

    results = []
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        futs = [ex.submit(run_one, a, s, mp, args.variant, args.force,
                          args.device)
                for a, s, mp in cells]
        for f in futs:
            results.append(f.result())

    failed = [r for r in results if not r["ok"]]
    print(f"\n{len(results) - len(failed)}/{len(results)} cells passed")
    summary = RESULTS_DIR / f"sweep_{args.variant}.json"
    summary.parent.mkdir(parents=True, exist_ok=True)
    summary.write_text(json.dumps(results, indent=2))
    if failed:
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
