#!/usr/bin/env python3
"""Probe of the SHA-256 engine (csrc/sha256_engine.cuh) on one GPU.

    python3 scripts/sha_engine_probe.py [--out FILE]

1. Builds the kernels and prints ptxas's register/shared-memory lines
   for ``sha256`` and ``fused``.
2. Reads, with a kernel of each launch's shape, the hardware warp slot
   of every warp (its sub-partition is the slot mod 4).
3. Counts the consumer warp's instructions per round in the compiled
   SASS (``cuobjdump -sass`` on the built libraries): the loop with the
   most funnel shifts that also loads W+K from shared memory is the
   consumer's round loop (32 rounds); its opcodes are sorted into the
   INT32 (ALU) pipe, the FMA pipe (IMAD) and the rest, and the stall
   counts of its control words summed (the cycles of ptxas's static
   schedule, before any wait on a scoreboard).

The kernels' times are chip_smoke.py's (phase 2); this script runs no
timing of its own.

Writes a JSON summary to `--out` (default chiprun_out/sha_engine_probe.json)
and prints it. Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TILE_CHUNKS = 256
ALU = {"LOP3", "SHF", "IADD3", "ISETP", "SEL", "PRMT", "LEA", "IADD",
       "VIADD", "SHL", "SHR", "MOV", "LOP", "IABS", "IMNMX", "VIMNMX",
       "FSEL", "PLOP3", "P2R", "R2P", "UIADD3", "ULOP3", "USHF", "UMOV"}
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)")


def cuobjdump() -> str | None:
    found = shutil.which("cuobjdump")
    if found:
        return found
    for cand in [Path("/usr/local/cuda/bin/cuobjdump")]:
        if cand.exists():
            return str(cand)
    try:
        import triton
        cand = Path(triton.__file__).parent / "backends/nvidia/bin/cuobjdump"
        return str(cand) if cand.exists() else None
    except ImportError:
        return None


def functions(sass: str) -> dict:
    """{function name: [(address, opcode, branch target or None)]} of a
    SASS listing; a target is an address (``BRA 0x1f0``) or a label
    (``BRA `(.L_x_3)``, resolved to the address that follows it)."""
    out, cur, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*(\.L\w+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(line)
        if m and cur is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            t = re.search(r"BRA\s+(?:`\((\.L\w+)\)|0x([0-9a-f]+))", line)
            target = None if not t else (t.group(1) or int(t.group(2), 16))
            cur.append([addr, m.group(3), target, 0])
            continue
        m = re.fullmatch(r"\s*/\*\s*0x([0-9a-f]{16})\s*\*/\s*", line)
        if m and cur:
            # the high word of the last instruction: its stall count, the
            # cycles the scheduler waits before the warp's next issue
            cur[-1][3] = (int(m.group(1), 16) >> 41) & 0xF
    return {fn: [(a, o, labels.get(t, t) if isinstance(t, str) else t, st)
                 for a, o, t, st in insns] for fn, insns in out.items()}


def consumer_loop(insns: list) -> Counter | None:
    """Opcode counts of the loop (a backward branch's span) with the
    most funnel shifts among those that read shared memory and write
    none (the producers' loops store W+K)."""
    best, best_shf = None, 0
    for addr, op, target, _ in insns:
        if not op.startswith("BRA") or not isinstance(target, int) \
                or target >= addr:
            continue
        lo = target
        span = [o for a, o, _, _ in insns if lo <= a <= addr]
        shf = sum(o.startswith("SHF.R.W") for o in span)
        if shf > best_shf and any(o.startswith("LDS") for o in span) \
                and not any(o.startswith("STS") for o in span):
            best, best_shf = Counter(span), shf
            best["stall cycles"] = sum(st for a, _, _, st in insns
                                       if lo <= a <= addr)
    return best


def pipe_counts(ops: Counter) -> dict:
    """Instructions per round by pipe, and the stall cycles that ptxas
    encoded per round (the static schedule's length). The loop holds
    rounds / 6 funnel shifts (three per Sigma, two Sigmas a round)."""
    ops = Counter(ops)
    stall = ops.pop("stall cycles", 0)
    rounds = max(1, sum(n for o, n in ops.items()
                        if o.startswith("SHF.R.W")) // 6)
    alu = sum(n for o, n in ops.items() if o.split(".")[0] in ALU)
    fma = sum(n for o, n in ops.items() if o.startswith("IMAD"))
    rest = sum(ops.values()) - alu - fma
    return {"rounds": rounds, "alu_per_round": alu / rounds,
            "fma_per_round": fma / rounds, "other_per_round": rest / rounds,
            "stall_cycles_per_round": stall / rounds,
            "opcodes": dict(ops.most_common())}


def sass_report(info: dict) -> dict:
    tool = cuobjdump()
    if tool is None:
        return {"error": "cuobjdump not found"}
    out = {}
    for name in ("sha256", "fused"):
        sass = subprocess.run([tool, "-sass", info[name]["lib"]],
                              capture_output=True, text=True).stdout
        for fn, insns in functions(sass).items():
            loop = consumer_loop(insns)
            if loop is not None:
                out[f"{name}:{fn}"] = pipe_counts(loop)
    return out


SLOTS_CU = r"""
#include <cuda_runtime.h>
__global__ void slots(unsigned* out) {
  extern __shared__ unsigned char sm[];
  unsigned w, s;
  asm volatile("mov.u32 %0, %%warpid;" : "=r"(w));
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  sm[threadIdx.x] = (unsigned char)w;
  if (threadIdx.x % 32 == 0) {
    unsigned i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    out[2 * i] = s;
    out[2 * i + 1] = w;
  }
}
extern "C" int slots_launch(void* out, int blocks, int threads, int smem) {
  cudaFuncSetAttribute(slots, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  slots<<<blocks, threads, smem>>>((unsigned*)out);
  return (int)cudaGetLastError();
}
"""


def warp_slots(geometries: dict) -> dict:
    """For each launch shape (blocks, threads, dynamic shared bytes): the
    hardware warp slot (%warpid) of every warp of the first blocks, and
    so its sub-partition (slot mod 4), read by a kernel of that shape."""
    import ctypes

    import torch

    from repro_torch import kernels
    src = kernels.build_dir() / "warp_slots.cu"
    lib = kernels.build_dir() / "libwarp_slots.so"
    src.write_text(SLOTS_CU)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).slots_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    out = {}
    for name, (blocks, threads, smem) in geometries.items():
        buf = torch.zeros(2 * blocks * threads // 32, dtype=torch.int32,
                          device="cuda")
        err = fn(buf.data_ptr(), blocks, threads, smem)
        torch.cuda.synchronize()
        v = buf.view(-1, threads // 32, 2).cpu().tolist()
        out[name] = {"error": err, "blocks": [
            {"sm": b[0][0], "slots": [w for _, w in b],
             "subpartitions": [w % 4 for _, w in b]} for b in v[:3]]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "sha_engine_probe.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sha_engine_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels.fused import ops as fops
    from repro_torch.kernels.sha256 import ops as sops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    info = kernels.build_all()
    summary = {"card": smi, "ptxas": {}}
    for name in ("sha256", "fused"):
        summary["ptxas"][name] = [
            ln.strip() for ln in info[name]["ptxas"].splitlines()
            if "registers" in ln or "spill" in ln or "smem" in ln]
    summary["sass"] = sass_report(info)
    sg, fg = sops.geometry(TILE_CHUNKS), fops.geometry(TILE_CHUNKS)
    summary["geometry"] = {"sha256": sg, "fused": fg}
    summary["warp_slots"] = warp_slots({
        "sha256": (sg["blocks"], sg["threads"], sg["smem_bytes"]),
        "fused": (fg["hash_blocks"] + fg["ctr_blocks"], fg["threads"],
                  fg["smem_bytes"])})
    ok = len(summary["sass"]) == 2 and all(
        isinstance(r, dict) and "alu_per_round" in r
        for r in summary["sass"].values())
    summary["ok"] = ok
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "sass"}))
    for fn, rep in summary["sass"].items():
        if isinstance(rep, dict):
            rep = {k: v for k, v in rep.items() if k != "opcodes"}
        print(fn[:100], json.dumps(rep))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
