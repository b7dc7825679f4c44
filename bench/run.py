#!/usr/bin/env python3
"""Runs one cell of the benchmark of ``repro_torch`` once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is the workload of that name in ``BENCHMARK.json``; its
configuration, traffic mix and metric readers are files found by name
(``benchkit.spec``). The run sets up (weights drawn on the card from the
seed, publishes, a warm tier), measures a closed-loop window of
`--seconds`, checks what the window produced against the plain
reference (``benchkit.reference``), and prints one JSON object as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, read under ``torch.profiler``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each number compared
beside its limit, which also end standard error.

It needs a CUDA card and exits non-zero, printing no result, without
one, or when the run loaded ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro``. The kernels' builds stay in the checkout's
``build/``; the origin store lives in a fresh directory under
``TMPDIR`` and is removed at exit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT / "src"))

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "repro"))


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that the port's runs must not
    load, each name compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def read_metrics(run, entries: list) -> dict:
    """{name: {value, unit}} of each metric entry whose reader found
    something to read."""
    from benchkit.spec import load_reader
    out = {}
    for m in entries:
        value = load_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def measure(cell, *, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """Set-up, window and check of `cell` on `device`: the result line
    (without the device's name)."""
    from benchkit.cell import CellRun
    cr = CellRun(cell, seed, device, traced=trace)
    try:
        cr.setup()
        run = cr.run
        run.setup["total_s"] = time.perf_counter() - t_start
        cr.window(seconds)
        peak = run.memory_peak_bytes
        checks = cr.check()
        metrics = read_metrics(run, cell.per_layer if trace
                               else cell.end_to_end)
        device = {"memory_peak_bytes": int(peak)}
        out = {"attempted": len(run.records),
               "failed": checks["failed"]["value"]}
        print("bench: set-up seconds", json.dumps(run.setup),
              "window", run.window_s, "cold starts", len(run.done),
              file=sys.stderr)
        print("bench: cold starts (client, begin, end, fetch, decode, "
              "load)", json.dumps([
                  [r["client"], round(r["begin"], 3), round(r["end"], 3),
                   round(r["stats"]["fetch_wall_s"] or 0, 3),
                   round(r["stats"]["decode_wall_s"] or 0, 3),
                   round(r["stats"]["load_seconds"]
                         - r["stats"]["restore_seconds"], 3)]
                  for r in run.done]), file=sys.stderr)
        print("bench: host over the window", json.dumps(run.host),
              file=sys.stderr)
        if trace:
            device.update(busy_s=run.trace.busy_s(), window_s=run.window_s)
            out["breakdown"] = run.trace.breakdown()
        out.update(
            correct=bool(run.done) and run.answers_checked > 0
            and all(c["value"] <= c["limit"] for c in checks.values()),
            metrics=metrics, device=device, checks=checks)
        return out
    finally:
        cr.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    from benchkit.spec import find_cell
    cell = find_cell(args.workload)
    chips = int(cell.workload["chips"])
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    result_out = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        out = measure(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda:0",
                      t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}; the port's runs must not",
              file=sys.stderr)
        return 4
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": chips, **out["device"]}
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks")
    print(json.dumps({k: out[k] for k in keys if k in out}),
          file=result_out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
