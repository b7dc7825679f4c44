"""What a run reads from the repository: ``BENCHMARK.json``, and the files
it names by name. A cell is found by its workload name; its configuration
by the config entry's ``file``; its traffic mix in
``bench/traffic/<traffic>.json``; each per-layer metric's reader in
``bench/metrics/<metric>.py``. A cell, a mix or a metric is added by
adding files and entries, never by editing one that is there."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    workload: dict          # the BENCHMARK.json entry
    config: dict            # the configuration file's contents
    mix: dict               # the traffic mix file's contents
    end_to_end: list        # the cell's end-to-end metric entries
    per_layer: list         # the cell's per-layer metric entries

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _for_cell(entries: list, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def find_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell `name` of ``BENCHMARK.json`` with its files read; raises
    KeyError for an unknown name and OSError for a missing file."""
    bench = bench if bench is not None else load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic"
                      / f"{work['traffic']}.json").read_text())
    return Cell(work, config, mix, _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name))


def load_reader(metric: str, root: Path = ROOT):
    """The module of ``bench/metrics/<metric>.py``: its ``LAYER``,
    ``UNIT``, ``SOURCE``, ``MOVES`` and ``read(run) -> number | None``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
