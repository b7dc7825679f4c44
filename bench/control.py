#!/usr/bin/env python3
"""The control of the check that decides ``correct``, at a cell's own
size: the cell run with the program's own lower-precision path switched
on (each model loads its weights in bfloat16, the precision below the
float32 the configuration serves), which must come out not correct.

    python3 bench/control.py --workload <name> --seeds 5 6 7 \
        [--seconds 4] [--dtype bfloat16]

One process runs each seed's set-up, a short window at the cell's load
and the check, and prints per seed the numbers compared beside their
limits as one JSON line. ``--dtype float32`` gives sound readings of the
same numbers. Needs a CUDA card. The benchmark's runs never run this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench_run  # noqa: E402


def with_dtype(cell, dtype: str):
    """A copy of `cell` whose models load in `dtype`."""
    cell = copy.deepcopy(cell)
    cell.config["serve_dtype"] = dtype
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)

    from benchkit.spec import find_cell
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    cell = with_dtype(find_cell(args.workload), args.dtype)
    out = sys.stdout
    for seed in args.seeds:
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = bench_run.measure(cell, seed=seed, seconds=args.seconds,
                                    trace=False, device="cuda:0", t_start=t)
        print(json.dumps({"workload": args.workload, "dtype": args.dtype,
                          "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"],
                          "seconds": time.perf_counter() - t}),
              file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
