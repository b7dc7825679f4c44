"""The port's dry run (``repro_torch.launch.dryrun``) and sweep driver
(``repro_torch.launch.sweep``) on the CPU: ``run_one`` launches
``python -m repro_torch.launch.dryrun`` for smollm-360m x decode_32k on
the fake 16 x 16 process group (one subprocess, full width and depth,
fake tensors), whose record must carry the reference's keys (and the
port's divergences), 256 chips, and the reference's ``model_flops`` and
parameter counts; the sweep's flags are the reference's."""
import json
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jconfig  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.launch.modelflops import model_flops as jmodel_flops  # noqa: E402
from repro.launch.modelflops import param_counts as jparam_counts  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402

REF = Path(__file__).resolve().parents[1] / "src/repro/launch"
REF_KEYS = {"arch", "shape", "variant", "mesh", "chips", "lower_s",
            "compile_s", "param_count", "param_active", "memory",
            "xla_cost_analysis", "roofline", "hlo_bytes"}


def _flags(path: Path) -> set:
    return set(re.findall(r'add_argument\("(--[\w-]+)"', path.read_text()))


def test_flags_match_the_reference():
    """The reference's flags, and ``--device`` (ROADMAP.md §3)."""
    port = Path(__file__).resolve().parents[1] / "src/repro_torch/launch"
    for name in ("dryrun.py", "sweep.py"):
        assert _flags(port / name) == _flags(REF / name) | {"--device"}


def test_run_one_decode_cell(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_DIR", str(tmp_path))
    from repro_torch.launch import sweep
    monkeypatch.setattr(sweep, "RESULTS_DIR", tmp_path)
    res = sweep.run_one("smollm-360m", "decode_32k", False, "baseline",
                        device="cpu")
    assert res["ok"], res.get("stderr")
    rec = json.loads((tmp_path / "smollm-360m_decode_32k_16x16_baseline"
                      ".json").read_text())
    assert REF_KEYS <= set(rec)
    assert set(rec["divergences"]) <= set(rec)
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    ref = jbuild(jconfig("smollm-360m"))
    mf = jmodel_flops(ref.cfg, JSHAPES["decode_32k"], ref.param_shapes())
    counts = jparam_counts(ref.cfg, ref.param_shapes())
    r = rec["roofline"]
    assert r["model_flops"] == mf and r["chips"] == 256
    assert rec["param_count"] == counts["total_with_embed"]
    assert rec["param_active"] == counts["active"]
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "per_device_total"}
    m = rec["memory"]
    assert m["per_device_total"] == m["argument_bytes"] + \
        m["output_bytes"] + m["temp_bytes"] - m["alias_bytes"]
    # the decode state is updated in place: the new caches are the old
    assert m["alias_bytes"] > 0
    assert r["flops"] > 0 and r["bytes"] > 0 and r["collective_bytes"] > 0
    assert r["step_time_s"] == max(r["compute_s"], r["memory_s"],
                                   r["collective_s"])
    # q, k and v of each of 32 layers gathered to split heads; the table
    assert rec["forced_replications"] == {"heads": 3 * 32, "embed": 1}
