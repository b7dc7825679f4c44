"""The launch tooling has no quiet CPU fallback: ``launch.mesh``'s mesh
builders and ``launch.dryrun``'s ``build_cell``, ``run_cell`` and CLI
default to ``"cuda"`` and go through ``repro_torch.resolve_device``, so
on a machine without a card they raise its error unless the caller asks
for ``"cpu"``, and with ``"cpu"`` they run as before."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
NO_CARD = "torch.cuda.is_available\\(\\) is False"
needs_no_card = pytest.mark.skipif(torch.cuda.is_available(),
                                   reason="a card is present")


def _run(code: str, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, *args] if not code else
                          [sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=240)


@needs_no_card
def test_mesh_builders_raise_without_a_card():
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    with pytest.raises(RuntimeError, match=NO_CARD):
        make_local_mesh(1, 1)
    with pytest.raises(RuntimeError, match=NO_CARD):
        make_production_mesh()
    with pytest.raises(ValueError, match="unsupported device"):
        make_local_mesh(1, 1, device_type="meta")


@needs_no_card
def test_dryrun_cell_raises_without_a_card():
    from repro_torch.launch.dryrun import build_cell, run_cell
    with pytest.raises(RuntimeError, match=NO_CARD):
        build_cell("smollm-360m", "decode_32k", None)
    with pytest.raises(RuntimeError, match=NO_CARD):
        run_cell("smollm-360m", "decode_32k", verbose=False)


@needs_no_card
def test_dryrun_cli_raises_without_a_card(tmp_path):
    env_dir = str(tmp_path)
    code = ("import os, sys; os.environ['REPRO_DRYRUN_DIR'] = %r; "
            "from repro_torch.launch import dryrun; "
            "dryrun.main(['--arch', 'smollm-360m', '--shape', "
            "'decode_32k'])" % env_dir)
    out = _run(code)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "pass device='cpu'" in out.stderr
    assert list(tmp_path.iterdir()) == []
    out = _run("", "-m", "repro_torch.launch.dryrun", "--arch",
               "smollm-360m", "--shape", "decode_32k", "--device", "tpu")
    assert out.returncode == 2 and "--device" in out.stderr


_CPU_PROBE = r"""
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.dryrun import build_cell, init_fake_world
from repro_torch.launch.mesh import make_production_mesh
dist.init_process_group("gloo", init_method="tcp://localhost:%d", rank=0,
                        world_size=1)
mesh = make_local_mesh(1, 1, device_type="cpu")
assert mesh.device_type == "cpu" and tuple(mesh.shape) == (1, 1)
assert mesh.mesh_dim_names == ("data", "model")
dist.destroy_process_group()
init_fake_world(256)
mesh = make_production_mesh(device_type="cpu")
assert mesh.device_type == "cpu" and tuple(mesh.shape) == (16, 16)
with FakeTensorMode(allow_non_fake_inputs=True):
    step, args, meta = build_cell("smollm-360m", "decode_32k", mesh,
                                  device="cpu")
params = args[0]
leaf = params["embed"]
assert leaf.device_mesh is mesh and leaf.to_local().device.type == "cpu"
assert meta["model"].device.type == "cpu"
print("ok")
"""


def test_cpu_when_asked():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = _run(_CPU_PROBE % port)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_device_defaults_to_cuda():
    import inspect

    from repro_torch.launch import dryrun, mesh, sweep
    for fn in (dryrun.build_cell, dryrun.run_cell, sweep.run_one):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (mesh.make_local_mesh, mesh.make_production_mesh):
        assert inspect.signature(fn).parameters["device_type"].default \
            == "cuda"
