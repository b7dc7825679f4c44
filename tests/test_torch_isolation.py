"""The port stands alone: importing every module of ``repro_torch``
loads neither jax, nor any module of the JAX package, nor ``ml_dtypes``
(which gives numpy a bfloat16: the port writes and reads bfloat16
leaves without it, as a fresh interpreter shows), and its entry points
refuse to run on the CPU unless asked to."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "ml_dtypes"))
             or m == "repro" or m.startswith("repro.")
             or m == "benchmarks" or m.startswith("benchmarks."))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for m in ("repro_torch.core.service", "repro_torch.serve.coldstart",
              "repro_torch.kernels.fused.ops", "repro_torch.models.lm",
              "repro_torch.core.cache.distributed",
              "repro_torch.kernels.gf256.ops",
              "repro_torch.kernels.parity.ops",
              "repro_torch.core.cache.peer", "repro_torch.core.retry",
              "repro_torch.core.faults", "repro_torch.core.gc",
              "repro_torch.core.loader", "repro_torch.launch.serve",
              "repro_torch.models.registry",
              "repro_torch.configs.starcoder2_15b",
              "repro_torch.configs.mistral_nemo_12b",
              "repro_torch.models.moe", "repro_torch.models.mamba",
              "repro_torch.models.blocks",
              "repro_torch.configs.arctic_480b",
              "repro_torch.configs.kimi_k2_1t",
              "repro_torch.configs.jamba_52b",
              "repro_torch.train.checkpoint", "repro_torch.train.optimizer",
              "repro_torch.train.step", "repro_torch.train.loop",
              "repro_torch.train.elastic", "repro_torch.data.synthetic",
              "repro_torch.launch.variants", "repro_torch.launch.train",
              "repro_torch.models.xlstm", "repro_torch.models.encdec",
              "repro_torch.configs.xlstm_350m",
              "repro_torch.configs.whisper_base",
              "repro_torch.configs.pixtral_12b",
              "repro_torch.sharding", "repro_torch.sharding.rules",
              "repro_torch.sharding.constrain",
              "repro_torch.sharding.collectives",
              "repro_torch.launch.mesh", "repro_torch.launch.modelflops",
              "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
              "repro_torch.launch.sweep", "repro_torch.examples",
              "repro_torch.examples.quickstart",
              "repro_torch.examples.serve_finetunes",
              "repro_torch.examples.coldstart_drill",
              "repro_torch.examples.train_lm"):
        assert m in res["modules"]


def test_examples_import_no_jax_repro_or_benchmarks():
    """The examples import inside ``main``: every import statement of
    ``repro_torch/examples/*.py``, at any depth, names torch, numpy, the
    standard library or the port; none names jax, the JAX package or the
    JAX round's ``benchmarks``."""
    import ast
    files = sorted((SRC / "repro_torch" / "examples").glob("*.py"))
    assert len(files) == 5
    for path in files:
        mods = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                mods.add((node.module or "").split(".")[0])
        assert "repro_torch" in mods or path.name == "__init__.py"
        assert not mods & {"jax", "jaxlib", "repro", "benchmarks",
                           "ml_dtypes"}, (path.name, mods)
        assert mods <= {"repro_torch", "numpy", "torch", "argparse",
                        "contextlib", "hashlib", "tempfile", "time",
                        "dataclasses", "__future__"}, (path.name, mods)


_BF16_PROBE = r"""
import sys, tempfile, torch
from repro_torch.core.service import ImageService, ServiceConfig
from repro_torch.core.store import ChunkStore
from repro_torch.core.manifest import open_manifest
t = torch.linspace(-3, 3, 1000).to(torch.bfloat16).reshape(10, 100)
svc = ImageService(ChunkStore(tempfile.mkdtemp()), ServiceConfig(
    device="cpu", decode_backend="python", root="R1"))
blob, _ = svc.publish({"m": t, "s": t[0, 0]}, tenant="t",
                      tenant_key=b"K" * 32, chunk_size=4096)
h = svc.open(blob, b"K" * 32)
got = h.restore_tree()
assert {r[0]: r[3] for r in open_manifest(blob, b"K" * 32).layout_table} \
    == {"m": "bfloat16", "s": "bfloat16"}
assert got["m"].dtype == torch.bfloat16 and torch.equal(got["m"], t)
assert torch.equal(got["s"], t[0, 0]) and torch.equal(h.tensor("m"), t)
assert "ml_dtypes" not in sys.modules and "jax" not in sys.modules
print("ok")
"""


def test_bfloat16_images_need_no_ml_dtypes():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _BF16_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_entry_points_default_to_cuda():
    from repro_torch.core.service import ServiceConfig
    from repro_torch.models import DecoderLM
    from repro_torch.configs import get_config
    cfg = get_config("smollm-360m").reduced()
    if torch.cuda.is_available():
        assert ServiceConfig().device == "cuda"
        assert DecoderLM(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        ServiceConfig()
    with pytest.raises(RuntimeError, match="cuda"):
        DecoderLM(cfg)
    assert ServiceConfig(device="cpu").device == "cpu"
