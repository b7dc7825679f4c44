"""Int8 Adam moments on DTensors (``repro_torch.train.optimizer``'s
``_Rows`` route) on the CPU.

One gloo launch of 4 ranks (``tests/_torch_dist_worker.py ... opt8``)
runs, on a (data 2, model 2) mesh under the rules of ``opt8bit`` and of
``zero3_tuned8`` (the mesh has no "pod" axis, so the rules drop it):

* two ``adamw_update`` calls on a reduced tinyllama's leaves and four
  more (``_torch_dist.OPT8_EXTRA``: sharded on non-leading dims with
  data spanning row ranks and a partial last block, replicated, and one
  with no dim that the row group divides), with no gradient clipping.
  The same calls on plain tensors are the single-device port. After
  each call the gathered ``q``, ``scale`` and params must equal the
  single-device ones bit for bit: the same gradients go in, and the
  update runs the same float32 operators on the same values.
* two train steps of the same model (``launch.dryrun.place_train_state``,
  ``train.step.make_train_step`` under the policy, the variant's
  ``OptConfig``) against the plain steps. Here the gradients and the
  clip factor come from partial sums added in another order, so they
  differ in the last bits (up to ~1e-6 relative here, twice that in
  v = g^2): the losses must agree within 1e-6 relative, ``q`` at most 1
  apart in at most 0.1% of the entries (``tests/test_torch_optimizer.py``'s
  int8 bound) and ``scale`` within 1e-5 of its max. A misrouted element
  would be off by its whole value.

A JAX process beside them runs the JAX package's ``adamw_update`` (no
clip) on the same numpy inputs (``_torch_dist.jax_opt8``): the
single-device port's ``q`` must equal it exactly, ``scale`` within 1e-7
relative. In this process: ``zero3_tuned8``'s and ``opt8bit``'s train step of a
reduced kimi-k2 built by ``launch.dryrun.build_step`` and traced under
``FakeTensorMode`` on a fake group of 4: each rank's moment bytes must
equal 2 R (block + 4) / F per leaf exactly (R the block rows padded to
512, F the fsdp ranks of the rule), before and after the step."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
sys.path.insert(0, str(TESTS))

from _torch_dist import OPT8_EXTRA, OPT8_VARIANTS, moe_config  # noqa: E402


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The worker ranks' results ("w4") and the JAX side's ("ref"), run
    together."""
    tmp = tmp_path_factory.mktemp("opt8")
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{TESTS}",
               OMP_NUM_THREADS="1")
    port = _port()
    cmds = [[str(TESTS / "_torch_dist.py"), str(tmp / "ref.npz"), "opt8"]]
    cmds += [[str(TESTS / "_torch_dist_worker.py"), "4", str(r), str(port),
              str(tmp / "w4.npz"), "opt8"] for r in range(4)]
    procs = []
    try:
        for c in cmds:
            procs.append(subprocess.Popen(
                [sys.executable] + c, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=120)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        # a time limit or timeout mid-wait leaves no gloo rank running
        for p in procs:
            with p:
                p.kill()
    assert not errs, errs[0]
    res = np.load(tmp / "w4.npz")
    return {"ref": np.load(tmp / "ref.npz"), **{k: res[k] for k in res.files}}


def _pairs(res, prefix: str) -> list:
    names = [k[len(prefix) + 6:] for k in res
             if k.startswith(prefix + "/mesh/")]
    return [(n, res[f"{prefix}/mesh/{n}"], res[f"{prefix}/plain/{n}"])
            for n in sorted(names)]


@pytest.mark.parametrize("variant", OPT8_VARIANTS)
def test_sharded_update_equals_single_device(results, variant):
    leaves = {f"x/{k}" for k in OPT8_EXTRA} | {"embed", "g0/s0/mixer/wo"}
    for step in range(2):
        pairs = _pairs(results, f"{variant}/update{step}")
        seen = {n.split("/", 1)[1].rsplit("/", 1)[0] for n, _, _ in pairs
                if n.startswith(("m/", "v/"))}
        assert leaves <= seen
        assert len(pairs) == 5 * len({n for n, _, _ in pairs
                                      if n.startswith("param/")})
        for name, got, want in pairs:
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    placed = dict(s.split(": ", 1) for s in results[f"{variant}/placements"])
    # the cases that raised before the route: non-leading dims
    assert placed["g0/s0/mixer/wo"] == ("(Shard(dim=2), Shard(dim=1))"
                                       if variant == "opt8bit" else
                                       "(Shard(dim=2), Shard(dim=2))")
    assert placed["x/expert"] == "(Shard(dim=2), Shard(dim=1))"
    assert placed["x/tiny"] == "(Replicate(), Replicate())"
    # opt8bit's rows are replicated over "model", where the params are
    # sharded; zero3_tuned8's rows cover the mesh. "tiny" is gathered.
    want = {"opt8_replicate"} | ({"opt8_gather"} if variant == "opt8bit"
                                else set())
    assert set(results[f"{variant}/update_forced"]) == want


@pytest.mark.parametrize("variant", OPT8_VARIANTS)
def test_sharded_train_steps_match_single_device(results, variant):
    got = results[f"{variant}/train/mesh_losses"]
    want = results[f"{variant}/train/plain_losses"]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for step in range(2):
        pairs = _pairs(results, f"{variant}/train{step}")
        assert len(pairs) == 2 * 2 * 12       # m, v x q, scale x leaves
        for name, a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if name.endswith("/q"):
                diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
            else:
                assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
    # the port's deliberate redistributions, by site (none is silent)
    forced = set(results[f"{variant}/train_forced"])
    assert forced <= {"embed", "heads", "opt8_gather", "xent_vocab"}


def test_single_device_int8_matches_jax(results):
    """The single-device port's moments (the worker's plain updates)
    against the JAX package's on the same inputs: ``q`` exact, ``scale``
    within 1e-7 relative (no clip, so the same float32 operators)."""
    ref = results["ref"]
    for step in range(2):
        pre = f"opt8bit/update{step}/plain/"
        names = sorted(k[len(pre):] for k in results if k.startswith(pre)
                       and not k.startswith(pre + "param/"))
        assert len(names) == 2 * 2 * (12 + len(OPT8_EXTRA))
        assert sorted(k[len(f"update{step}/"):] for k in ref.files
                      if k.startswith(f"update{step}/")) == names
        for name in names:
            got, want = results[pre + name], ref[f"update{step}/{name}"]
            assert got.dtype == want.dtype and got.shape == want.shape, name
            if name.endswith("/q"):
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                assert np.abs(got - want).max() <= 1e-7 * np.abs(want).max()


@pytest.fixture
def fake_world():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import init_fake_world
    init_fake_world(4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _moment_bytes(opt: dict) -> int:
    from repro_torch.sharding.rules import local_nbytes
    from repro_torch.train.optimizer import _flatten, _is_q8

    return sum(local_nbytes(s[part]) for key in ("m", "v")
               for s in _flatten(opt[key], _is_q8) for part in ("q", "scale"))


@pytest.mark.parametrize("variant", OPT8_VARIANTS)
def test_fake_trace_holds_the_moments_at_their_size(fake_world, variant):
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import build_step
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.roofline import count_step
    from repro_torch.launch.variants import get_variant
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.constrain import FORCED
    from repro_torch.sharding.rules import mesh_shape
    from repro_torch.train.optimizer import _SHARD_PAD, OptConfig

    cfg = dataclasses.replace(moe_config(get_config), num_layers=2)
    policy, flags, over = get_variant(variant, cfg, SHAPES["train_4k"])
    flags = dataclasses.replace(flags, chunked_loss=(
        16 if flags.chunked_loss else 0))
    opt = OptConfig(**over)
    mesh = make_local_mesh(2, 2, device_type="cpu")
    model = build_model(cfg, flags, device="cpu")
    sizes = mesh_shape(mesh)
    F = 1
    for a in policy.rules["fsdp"]:
        F *= sizes.get(a, 1)
    want = 0
    for leaf in _leaf_shapes(model.param_shapes()):
        n = int(np.prod(leaf))
        rows = -(-n // opt.block)
        rows += (-rows) % _SHARD_PAD
        want += 2 * rows * (opt.block + 4) // F
    FORCED.clear()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = build_step(model, ShapeConfig("t", 32, 4, "train"),
                                mesh, policy, opt, "cpu")
        assert _moment_bytes(args[0]["opt"]) == want
        (out, metrics), costs = count_step(step, *args)
    assert _moment_bytes(out["opt"]) == want
    assert costs.dot_flops > 0 and metrics["loss"].shape == ()
    # zero3_tuned8's rows cover the mesh: nothing gathered for them
    assert "opt8_replicate" not in FORCED
    assert ("opt8_gather" in FORCED) == (variant == "opt8bit")


def _leaf_shapes(tree) -> list:
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _leaf_shapes(tree[k])]
    return [tuple(tree.shape)]


def test_no_route_names_the_leaf(fake_world):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.optimizer import OptConfig, adamw_update

    mesh = make_local_mesh(2, 2, device_type="cpu")
    cfg = OptConfig(moments="int8")

    def place(shape, placements):
        local = list(shape)
        for size, p in zip(tuple(mesh.shape), placements):
            if isinstance(p, Shard):
                local[p.dim] //= size
        return DTensor.from_local(torch.zeros(local), mesh, placements,
                                  run_check=False)
    with FakeTensorMode(allow_non_fake_inputs=True):
        w = place((8, 64), [Shard(0), Replicate()])
        bad = {"q": place((512, 256), [Replicate(), Shard(1)]).to(torch.int8),
               "scale": place((512, 1), [Replicate(), Replicate()])}
        state = {"m": {"w": bad}, "v": {"w": bad},
                 "step": torch.zeros((), dtype=torch.int32)}
        with pytest.raises(ValueError, match=r"int8 moments of w: .*Shard"):
            adamw_update({"w": w}, {"w": w}, state, cfg)
