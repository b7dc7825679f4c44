#!/usr/bin/env python3
"""SASS counts of the AES kernel's round loop (csrc/aes.cu).

    python3 scripts/aes_sass_probe.py [--out FILE]

1. Builds ``aes.cu`` with the port's nvcc flags and prints ptxas's
   register/shared-memory lines.
2. Finds, in ``cuobjdump -sass`` of the library, the round loop with
   shared-memory round keys: the loop with one LDS.128 (the round key)
   and 16 LDS (the table reads). Counts its opcodes per round, grouped
   as LDS, PRMT, SHF, LOP3, IMAD and the rest, and sums the stall counts
   of its control words (the cycles of ptxas's static schedule).

The kernel's time is chip_smoke.py's (phase 2); this script runs no
timing of its own and needs no card, only nvcc and cuobjdump from the
CUDA toolkit. Writes a JSON summary to --out (default
chiprun_out/aes_sass_probe.json) and prints it; exits 2 without nvcc or
cuobjdump, 1 if the loop is not found.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

from sha_engine_probe import cuobjdump, functions  # noqa: E402

GROUPS = ("LDS", "PRMT", "SHF", "LOP3", "IMAD")


def round_loop(insns: list) -> Counter | None:
    """Opcodes of the loop (a backward branch's span) that loads one
    round key (LDS.128) and 16 table words (LDS), with its stall cycles."""
    for addr, op, target, _ in insns:
        if not op.startswith("BRA") or not isinstance(target, int) \
                or target >= addr:
            continue
        span = [(o, st) for a, o, _, st in insns if target <= a <= addr]
        ops = Counter(o for o, _ in span)
        if ops.get("LDS.128", 0) == 1 and ops.get("LDS", 0) == 16:
            ops["stall cycles"] = sum(st for _, st in span)
            return ops
    return None


def per_round(ops: Counter) -> dict:
    ops = Counter(ops)
    stall = ops.pop("stall cycles", 0)
    group = Counter()
    for o, n in ops.items():
        head = o.split(".")[0]
        group[o if o == "LDS.128" else head if head in GROUPS
              else "other"] += n
    return {**dict(group), "total": sum(ops.values()), "stall_cycles": stall,
            "opcodes": dict(ops.most_common())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "aes_sass_probe.json"))
    args = ap.parse_args()
    from repro_torch import kernels
    tool = cuobjdump()
    try:
        nvcc = kernels._nvcc()
    except RuntimeError as e:
        print(f"aes_sass_probe: {e}", file=sys.stderr)
        return 2
    if tool is None:
        print("aes_sass_probe: cuobjdump not found", file=sys.stderr)
        return 2
    out_dir = kernels.build_dir() / "aes_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libaes.so"
    built = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-I",
                            str(kernels.CSRC), "-o", str(lib),
                            str(kernels.CSRC / "aes.cu")],
                           capture_output=True, text=True)
    log = built.stdout + built.stderr
    if built.returncode:
        raise RuntimeError(f"nvcc aes.cu failed:\n{log}")
    summary = {"ptxas": [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln
                         or "smem" in ln]}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    loops = [round_loop(i) for i in functions(sass).values()]
    loops = [x for x in loops if x is not None]
    summary["sass_per_round"] = per_round(loops[0]) if loops \
        else "round loop not found"
    summary["ok"] = bool(loops)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
