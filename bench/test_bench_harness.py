"""CPU tests of the benchmark's harness: cells, mixes and metrics found by
name, the result line, the module guard, and the arithmetic of the rate,
the roofline and the device's idle union."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import bench_cpu_cells
from benchkit import roofline, spec
from benchkit.cell import Function, Run
from benchkit.trace import DeviceTrace, busy_union

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.find_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert {"clients", "worker", "l1_bytes"} <= set(cell.mix)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer


def test_metric_entries_match_their_readers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        reader = spec.load_reader(m["name"])
        assert (reader.UNIT, reader.SOURCE) == (m["unit"], m["source"]), m
        if "layer" in m:
            assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
            assert m["moves"] in e2e
            layers.add(m["layer"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200


def test_cell_added_as_files_only(tmp_path):
    """A new mix, a new metric and a new cell: files and entries only."""
    shutil.copytree(spec.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "bench" / "traffic" / "burst-l1.json").write_text(
        json.dumps({"clients": 2, "worker": "shared", "l1_bytes": 1 << 30,
                    "retain_share": 0.5, "retain_max": 2,
                    "check_ciphertexts": 1}))
    (tmp_path / "bench" / "metrics" / "coldstarts_done.py").write_text(
        'LAYER = "cold start (serve/coldstart.py)"\nUNIT = "starts"\n'
        'SOURCE = "host_clock"\nMOVES = "coldstart_GBps"\n\n\n'
        'def read(run):\n    return len(run.done) or None\n')
    if "xlstm-350m" not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({"name": "xlstm-350m",
                                 "file": "bench/configs/xlstm-350m.json"})
    bench["workloads"].append({"name": "xlstm-350m.burst-l1",
                               "config": "xlstm-350m", "traffic": "burst-l1",
                               "chips": 1, "why": "two clients"})
    bench["per_layer"].append({"name": "coldstarts_done", "unit": "starts",
                               "better": "higher", "source": "host_clock",
                               "layer": "cold start (serve/coldstart.py)",
                               "moves": "coldstart_GBps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("xlstm-350m.burst-l1", root=tmp_path)
    assert cell.mix["clients"] == 2
    assert "coldstarts_done" in [m["name"] for m in cell.per_layer]
    reader = spec.load_reader("coldstarts_done", root=tmp_path)
    assert reader.read(Run(cell, "cpu", records=[{"stats": {}}])) == 1
    # the cells already there still resolve unchanged
    for name in CELLS:
        assert spec.find_cell(name, root=tmp_path).config \
            == spec.find_cell(name).config


def test_result_line_keys_and_checks_last():
    out = bench_cpu_cells.measure(
        bench_cpu_cells.cpu_cell("xlstm-350m.restart-l1"), trace=True)
    assert {"correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks"} <= set(out)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in out["checks"].values())
    assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(out["device"])
    assert "load_into_model_s" in out["metrics"]


def test_no_card_no_result(capsys):
    import torch

    import run
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path does not run")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_names_compared_whole():
    from run import forbidden_modules
    assert forbidden_modules(["repro_torch.core", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["repro.core.layout", "jax._src",
                              "jaxlib.xla", "flax"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_no_jax_or_reference_package():
    """A whole CPU run in a fresh process: nothing named jax, jaxlib,
    flax or repro is loaded once the window has closed."""
    code = (
        "import bench_cpu_cells, run\n"
        "for n in ('whisper-base.scaleout-l2', 'xlstm-350m.restart-l1'):\n"
        "    out = bench_cpu_cells.measure(bench_cpu_cells.cpu_cell(n),"
        " seconds=0.2)\n"
        "    assert out['correct'], out\n"
        "print(run.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=spec.BENCH,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_rate_counts_work_in_flight_at_the_window_end():
    """Cold starts begun before the window's end are all counted, and the
    time runs to the last return (3 begun, the last ends at 14 s)."""
    reader = spec.load_reader("coldstart_GBps")
    run = Run(None, "cpu", functions=[Function({}, image_bytes=2_000_000_000),
                                      Function({}, image_bytes=500_000_000)])
    run.records = [
        {"function": 0, "begin": 0.0, "end": 6.0, "stats": {}},
        {"function": 1, "begin": 6.0, "end": 9.5, "stats": {}},
        {"function": 0, "begin": 9.5, "end": 14.0, "stats": {}},
        {"function": 1, "begin": 0.0, "end": 3.0, "error": "x"}]
    run.window_s = max(r["end"] for r in run.records)
    assert reader.read(run) == pytest.approx(4.5 / 14.0)


def test_roofline_numerator_of_one_chunk():
    ops, nbytes = roofline.decode_work(1, 512 * 1024)
    # 524,288 bytes + 0x80 + 8-byte length -> 8,193 64-byte blocks at
    # 16 + 480 + 896 + 8 = 1400 instructions; 32,768 AES blocks at
    # 4 + 312 + 32 = 348
    assert ops == 8193 * 1400 + 32768 * 348
    assert nbytes == 2 * 524288 + 32
    least, by = roofline.least_seconds(ops, nbytes)
    assert by == "operations"
    assert least == pytest.approx(ops / (132 * 64 * 1.98e9))


def test_idle_union_on_a_synthetic_trace():
    events = [("fused_kernel", 0.0, 2.0), ("Memcpy HtoD", 1.0, 3.0),
              ("fused_kernel", 5.0, 6.0), ("Memset", 5.5, 7.0),
              ("fused_kernel", 9.0, 9.5)]
    tr = DeviceTrace(events, spans=[(6.5, 10.0)])
    assert busy_union([(0, 1), (0.5, 2), (3, 4)]) == 3
    assert tr.busy_s() == pytest.approx(3.0 + 2.0 + 0.5)
    assert tr.kernel_s() == pytest.approx(3.5)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["fused_kernel", 3.5]
    assert bd["idle_gaps"] == [["no_cold_start", 2.0],
                               ["cold_start", 2.0]]


def test_configs_match_the_port_registry():
    """The configuration files, those of cells and those kept for later,
    hold the port's published widths."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    files = sorted((spec.BENCH / "configs").glob("*.json"))
    assert {c["file"] for c in BENCH["configs"]} <= {
        str(f.relative_to(spec.ROOT)) for f in files}
    for f in files:
        config = json.loads(f.read_text())
        assert ModelConfig(**config["model"]) == get_config(f.stem)
        assert config["reduced"] == []
    assert all(c["reduced"] == [] for c in BENCH["configs"])


def test_shares_read_zero_rather_than_fall_silent():
    """The L2's share reads 0 where the window read chunks and the L2
    served none, and the idle share 100 where nothing ran on the card;
    each is silent only where there is nothing to read."""
    l2 = spec.load_reader("l2_hit_pct")
    idle = spec.load_reader("device_idle_pct")
    fn = Function({}, image_bytes=4 << 20, distinct_chunks=8)
    run = Run(None, "cpu", functions=[fn],
              records=[{"function": 0, "stats": {"l2_hits": 0}}])
    assert l2.read(run) == 0.0
    run.records[0]["stats"]["l2_hits"] = 6
    assert l2.read(run) == pytest.approx(75.0)
    assert l2.read(Run(None, "cpu", functions=[fn])) is None
    run.window_s = 2.0
    assert idle.read(run) is None
    run.trace = DeviceTrace([], spans=[])
    assert idle.read(run) == 100.0
    run.trace = DeviceTrace([("fused_kernel", 0.0, 0.5)], spans=[])
    assert idle.read(run) == pytest.approx(75.0)
