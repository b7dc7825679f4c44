"""The port's multi-rank paths on the CPU against the JAX package's: one
gloo launch of 8 ranks (``tests/_torch_dist_worker.py``) runs
``compressed_psum`` over all of them, then on a (data 2, model 4) mesh
the expert-parallel MoE (``moe_impl="shard_map"``: loss and every
gradient) and the sequence-parallel loss of a reduced arctic; one of 4
ranks runs two float32 train steps of a reduced tinyllama on a (2, 2)
mesh. The JAX side runs in one subprocess on 8 host devices with
``AxisType.Auto`` meshes (``tests/_torch_dist.py``). All three start
together; inputs come from the same numpy seeds."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{TESTS}",
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    procs = []
    try:
        procs.append(subprocess.Popen(
            [sys.executable, str(TESTS / "_torch_dist.py"),
             str(tmp / "ref.npz")],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
        for world in (8, 4):
            port = _port()
            procs += [subprocess.Popen(
                [sys.executable, str(TESTS / "_torch_dist_worker.py"),
                 str(world), str(r), str(port), str(tmp / f"w{world}.npz")],
                env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for r in range(world)]
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=240)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        # a time limit or timeout mid-wait leaves no gloo rank running
        for p in procs:
            with p:
                p.kill()
    assert not errs, errs[0]
    return {k: np.load(tmp / f"{k}.npz") for k in ("ref", "w8", "w4")}


def test_compressed_psum_matches_the_reference(results):
    ref, got = results["ref"], results["w8"]
    np.testing.assert_allclose(got["psum"], ref["psum"], rtol=0, atol=1e-6)
    # the same over a mesh dim named as a (DeviceMesh, dim) pair
    np.testing.assert_array_equal(got["psum_mesh"], got["psum"])
    # and the int8 wire format's error against the exact mean
    rel = np.abs(got["psum"] - ref["psum_exact"]).max() \
        / np.abs(ref["psum_exact"]).max()
    assert rel < 0.02


def test_expert_parallel_moe_matches_the_reference(results):
    ref, got = results["ref"], results["w8"]
    assert abs(float(got["moe_loss"]) - float(ref["moe_shard_map_loss"])) \
        < 1e-4
    names = [k.split("/", 1)[1] for k in got.files
             if k.startswith("moe_grad/")]
    assert len(names) == 7
    for name in names:
        np.testing.assert_allclose(got[f"moe_grad/{name}"],
                                   ref[f"moe_shard_map_grad/{name}"],
                                   rtol=2e-3, atol=2e-5, err_msg=name)


def test_sequence_parallel_loss_matches_the_reference(results):
    ref, got = results["ref"], results["w8"]
    assert "sp_loss" in ref.files, "the reference's SP route did not run"
    assert abs(float(got["sp_loss"]) - float(ref["sp_loss"])) < 2e-3
    assert abs(float(got["sp_loss"]) - float(ref["sp_plain_loss"])) < 2e-3
    assert abs(float(got["sp_plain_loss"]) - float(ref["sp_plain_loss"])) \
        < 2e-3
    # the port's deliberate replications, by site (none is silent)
    assert set(got["sp_forced"]) <= {"embed", "heads", "moe_sort_dispatch",
                                     "moe_sort_combine"}


def test_mesh_train_step_matches_single_device(results):
    ref, got = results["ref"], results["w4"]
    np.testing.assert_allclose(got["train_losses"], ref["train_losses"],
                               rtol=1e-4)
    # the state kept its FSDP x TP layout through both steps
    assert str(got["train_placements"]) == "(Shard(dim=1), Shard(dim=2))"
