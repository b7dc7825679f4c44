"""Cells of the benchmark cut to a size the CPU tests can hold: the
same files and code, with narrow models, 16 KiB chunks and the
program's numpy decode backend (its CUDA kernels run only on a card)."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchkit import spec  # noqa: E402


def any_cell(name: str):
    """The cell `name` of ``BENCHMARK.json``, or one whose files are kept
    under ``bench/`` for a later cell (``<config>.<traffic>``: the
    configuration and mix files of those names, with every metric
    entry of ``BENCHMARK.json``)."""
    try:
        return spec.find_cell(name)
    except KeyError:
        bench = spec.load_benchmark()
        config, traffic = name.split(".", 1)
        bench["configs"].append({"name": config,
                                 "file": f"bench/configs/{config}.json"})
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1})
        for m in bench["end_to_end"] + bench["per_layer"]:
            m.pop("workloads", None)
        return spec.find_cell(name, bench=bench)


def cpu_cell(name: str, **config):
    """The cell `name` (``any_cell``), cut to CPU size; `config`
    overrides top-level keys of its configuration (e.g.
    ``serve_dtype``)."""
    cell = copy.deepcopy(any_cell(name))
    m = cell.config["model"]
    m.update(d_model=64, num_heads=4, num_kv_heads=4, vocab_size=512,
             num_layers=2)
    if m.get("d_ff"):
        m["d_ff"] = 128
    if m.get("encoder_layers"):
        m["encoder_layers"] = 2
    cell.config["deployment"].update(chunk_size=16384,
                                     decode_backend="python",
                                     max_batch_bytes=1 << 20)
    cell.mix["l1_bytes"] = min(cell.mix["l1_bytes"], 8 << 20)
    cell.config.update(config)
    return cell


def measure(cell, seed: int = 2**31 + 11, seconds: float = 0.5,
            trace: bool = False) -> dict:
    import time

    import run
    return run.measure(cell, seed=seed, seconds=seconds, trace=trace,
                       device="cpu", t_start=time.perf_counter())
