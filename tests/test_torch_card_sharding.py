"""The sharded training path on one rank: a train step of reduced
SmolLM (float32) with its state as DTensors on a world-1 (1, 1) mesh
under the baseline policy (``launch.dryrun.place_train_state``) must
give the unsharded step's losses and weights, and the roofline counted
on that real step (``launch.roofline.count_step``) must equal a
fake-tensor trace of the same cell (``launch.dryrun.build_step``): the
same FLOPs and bytes, no collective bytes. The process group is gloo on
the CPU and NCCL on a card (marked ``cuda``):
    python -m pytest -m cuda tests/test_torch_card_sharding.py
Tolerances: losses within 1e-6 relative, weights within 1e-6 of each
tensor's max |value| (the same float32 operators run in both). With
int8 moments (``opt8bit``'s ``OptConfig``) the world-1 DTensor steps
run the block-row route of ``train.optimizer``: their losses and every
moment's ``q`` and ``scale`` must equal the unsharded steps' bit for
bit. This file imports neither the JAX package nor jax."""
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.synthetic import global_batch  # noqa: E402
from repro_torch.models.lm import DecoderLM, RunFlags, init_flat  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.step import make_train_step, nest  # noqa: E402

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
B, S = 2, 32


@pytest.fixture
def world_one(request):
    import torch.distributed as dist
    name = request.param if hasattr(request, "param") else "cpu"
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if name == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        yield torch.device(name)
    finally:
        dist.destroy_process_group()


def _state(cfg, dev, opt):
    params = nest({k: torch.from_numpy(v).to(dev)
                   for k, v in init_flat(cfg, 0).items()})
    return {"params": params, "opt": init_opt_state(params, opt)}


def _batches(cfg, dev):
    return [{k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in global_batch(cfg, s, B, S, seed=0).items()}
            for s in range(2)]


@pytest.mark.parametrize("world_one", DEVICES, indirect=True)
def test_world_one_mesh_step_equals_unsharded(world_one):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import (
        build_step,
        place_batch,
        place_train_state,
        under_policy,
    )
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.roofline import count_step
    from repro_torch.sharding.rules import ShardingPolicy

    dev = world_one
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("smollm-360m").reduced()
    opt = OptConfig()
    model = DecoderLM(cfg, RunFlags(dtype="float32"), device=dev)
    step = make_train_step(model, opt)
    plain, losses = _state(cfg, dev, opt), []
    for b in _batches(cfg, dev):
        plain, m = step(plain, b)
        losses.append(float(m["loss"]))

    mesh = make_local_mesh(1, 1, device_type=dev.type)
    policy = ShardingPolicy()
    shape = ShapeConfig("t", S, B, "train")
    sharded = under_policy(step, mesh, policy)
    state = place_train_state(model, _state(cfg, dev, opt), mesh, policy,
                              opt)
    got, costs = [], None
    for i, b in enumerate(_batches(cfg, dev)):
        b = place_batch(model, b, shape, mesh, policy)
        if i == 0:
            (state, m), costs = count_step(sharded, state, b)
        else:
            state, m = sharded(state, b)
        got.append(float(m["loss"].full_tensor()))
    np.testing.assert_allclose(got, losses, rtol=1e-6)
    w = state["params"]["g0"]["s0"]["mixer"]["wq"].full_tensor()
    want = plain["params"]["g0"]["s0"]["mixer"]["wq"]
    assert (w - want).abs().max() <= 1e-6 * want.abs().max()

    with FakeTensorMode(allow_non_fake_inputs=True):
        fstep, args = build_step(model, shape, mesh, policy, opt,
                                 dev.type)
        _, fake = count_step(fstep, *args)
    assert costs.dot_flops > 0 and costs.collective_bytes == 0
    assert (fake.dot_flops, fake.bytes_accessed, fake.collective_bytes) \
        == (costs.dot_flops, costs.bytes_accessed, costs.collective_bytes)


def _moments(opt: dict) -> dict:
    from repro_torch.train.optimizer import _flatten, _is_q8, _paths

    out = {}
    for key in ("m", "v"):
        for name, s in zip(_paths(opt[key]), _flatten(opt[key], _is_q8)):
            for part in ("q", "scale"):
                t = s[part]
                out[f"{key}/{name}/{part}"] = t.full_tensor() \
                    if hasattr(t, "full_tensor") else t
    return out


@pytest.mark.parametrize("world_one", DEVICES, indirect=True)
def test_world_one_int8_step_equals_unsharded(world_one):
    from repro_torch.launch.dryrun import (
        place_batch,
        place_train_state,
        under_policy,
    )
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.rules import ShardingPolicy

    dev = world_one
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("smollm-360m").reduced()
    opt = OptConfig(moments="int8")
    model = DecoderLM(cfg, RunFlags(dtype="float32"), device=dev)
    step = make_train_step(model, opt)
    plain, losses, want = _state(cfg, dev, opt), [], []
    for b in _batches(cfg, dev):
        plain, m = step(plain, b)
        losses.append(float(m["loss"]))
        want.append(_moments(plain["opt"]))

    mesh = make_local_mesh(1, 1, device_type=dev.type)
    policy = ShardingPolicy()
    shape = ShapeConfig("t", S, B, "train")
    sharded = under_policy(step, mesh, policy)
    state = place_train_state(model, _state(cfg, dev, opt), mesh, policy,
                              opt)
    assert hasattr(state["opt"]["m"]["embed"]["q"], "full_tensor")
    for i, b in enumerate(_batches(cfg, dev)):
        state, m = sharded(state, place_batch(model, b, shape, mesh, policy))
        assert float(m["loss"].full_tensor()) == losses[i]
        got = _moments(state["opt"])
        assert sorted(got) == sorted(want[i])
        for name, t in got.items():
            assert t.dtype == want[i][name].dtype, name
            assert torch.equal(t, want[i][name]), name
