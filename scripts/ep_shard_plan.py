#!/usr/bin/env python3
"""What each rank of an expert-parallel group fetches from the origin
when it restores its shard of an image (``expert_shard_restore``),
computed from a config's layout alone: no weights are made.

    PYTHONPATH=src python scripts/ep_shard_plan.py [--ep-size 4]

The config is the image of ``chip_smoke.py`` phase 8b (jamba-v0.1-52b,
one period, cut widths). Chunks are the layout's 512 KiB chunks. The
publish elides all-zero chunks and stores chunks of equal content once
(convergent encryption), and a restore fetches each distinct name once,
so a chunk costs an origin GET unless it is all zero or shares its
content with another chunk of the same restore. Contents are judged by
the port's init rules (``models.lm.init_rule``): ones, zeros and
``A_log`` tensors are the same in every layer, every other tensor is
random. Prints the image's chunks and bytes, the expert stacks' share,
and each rank's chunks, predicted GETs and bytes."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core.layout import build_layout, ranges_to_chunks, \
    shard_byte_ranges  # noqa: E402
from repro_torch.models.lm import init_rule, flat_specs, \
    param_specs  # noqa: E402
from repro_torch.serve.coldstart import expert_dim, \
    expert_shard_slices  # noqa: E402


def chunk_contents(layout, kinds: dict) -> list:
    """A content key per chunk: None for an all-zero chunk, a unique key
    for one holding random bytes, else the deterministic tensors it
    holds: (kind, what sets their bytes, offset in the chunk); ones and
    zeros are set by their byte count, ``A_log`` by its shape."""
    cs = layout.chunk_size
    keys = [[] for _ in range(layout.image_size // cs)]
    for t in layout.tensors.values():
        kind = kinds[t.name]
        what = t.nbytes if kind in ("ones", "zeros") else t.shape
        for c in ranges_to_chunks([(t.offset, t.nbytes)], cs):
            keys[c].append((kind, what, t.offset - c * cs))
    out = []
    for c, held in enumerate(keys):
        if any(k[0] == "normal" or k[0] == "dt_bias" for k in held):
            out.append(("random", c))
        elif all(k[0] == "zeros" for k in held):
            out.append(None)
        else:
            out.append(tuple(held))
    return out


def plan(cfg, ep_size: int) -> dict:
    specs = flat_specs(param_specs(cfg))
    layout = build_layout({n: np.broadcast_to(np.float32(0), sp.shape)
                           for n, sp in specs.items()})
    kinds = {n: init_rule(n, sp.shape)[0] for n, sp in specs.items()}
    contents = chunk_contents(layout, kinds)
    cs = layout.chunk_size

    def cost(chunks):
        distinct = {contents[c] for c in chunks} - {None}
        return {"chunks": len(chunks), "gets": len(distinct),
                "bytes": len(distinct) * cs}

    expert_bytes = sum(t.nbytes for n, t in layout.tensors.items()
                       if expert_dim(n, t.shape, cfg.num_experts) is not None)
    total_bytes = sum(t.nbytes for t in layout.tensors.values())
    image = cost(list(range(layout.image_size // cs)))
    ranks = []
    for r in range(ep_size):
        sl = expert_shard_slices(layout.tensors, cfg.num_experts, r, ep_size)
        ranges = []
        for n, s in sl.items():
            t = layout.tensors[n]
            ranges.extend([(t.offset, t.nbytes)] if s is None
                          else shard_byte_ranges(t, s))
        c = cost(ranges_to_chunks(ranges, cs))
        c["share_of_image_bytes"] = c["bytes"] / image["bytes"]
        ranks.append(c)
    return {"config": cfg.name, "params": sum(int(np.prod(sp.shape))
                                              for sp in specs.values()),
            "tensor_bytes": total_bytes,
            "expert_share_of_tensor_bytes": expert_bytes / total_bytes,
            "image": image, "ep_size": ep_size, "ranks": ranks}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ep-size", type=int, default=chip_smoke.EP_SIZE)
    args = ap.parse_args()
    print(json.dumps(plan(chip_smoke.ep_image_config(), args.ep_size),
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
