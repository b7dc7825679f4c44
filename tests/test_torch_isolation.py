"""The port stands alone: importing every module of ``repro_torch``
loads neither jax nor any module of the JAX package, and its entry
points refuse to run on the CPU unless asked to."""
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
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
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
              "repro_torch.configs.jamba_52b"):
        assert m in res["modules"]


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
