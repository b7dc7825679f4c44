"""The port's step counter (``repro_torch.launch.roofline``) against
the JAX HLO analyzer: the ring formulas on ``tests/test_roofline.py``'s
collective sizes, the scanned tanh model's dot FLOPs (exactly L x 2 x B
x D^2, and within 1% of ``analyze_hlo`` on its JAX lowering), and, in a
subprocess on a fake 4-rank process group, a column-parallel matmul on
a (2, 2) mesh that counts half its unsharded FLOPs on one rank and the
all-gather its output redistribution makes."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.launch.roofline import analyze_hlo  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_roofline import HLO_COLLECTIVES  # noqa: E402


def test_ring_formulas_match_the_analyzer():
    d = analyze_hlo(HLO_COLLECTIVES, total_devices=16).collective_detail
    ag, rs = 64 * 256 * 2, 4 * 256 * 2
    got = {"all-gather": 2 * roofline.ring_bytes("all-gather", ag, 16),
           "reduce-scatter": roofline.ring_bytes("reduce-scatter", rs, 16),
           "collective-permute": roofline.ring_bytes("collective-permute",
                                                     rs, 16),
           "all-to-all": roofline.ring_bytes("all-to-all", rs, 4)}
    assert got == pytest.approx(d, rel=0, abs=0)
    assert roofline.ring_bytes("all-reduce", 4096, 4) == 2 * 4096 * 3 / 4
    assert roofline.ring_bytes("all-gather", 4096, 1) == 0.0


def test_scanned_model_dot_flops():
    import jax
    import jax.numpy as jnp

    L, B, D = 6, 4, 128

    def jf(w, x):
        def body(h, wl):
            return jnp.tanh(h @ wl), None
        h, _ = jax.lax.scan(body, x, w)
        return h.sum()

    hlo = jax.jit(jf).lower(jax.ShapeDtypeStruct((L, D, D), jnp.float32),
                            jax.ShapeDtypeStruct((B, D), jnp.float32)) \
        .compile().as_text()
    want = L * 2 * B * D * D
    jax_flops = analyze_hlo(hlo, total_devices=1).dot_flops

    def f(w, x):
        for wl in w.unbind(0):
            x = torch.tanh(x @ wl)
        return x.sum()

    g = torch.Generator().manual_seed(0)
    w = torch.randn(L, D, D, generator=g)
    x = torch.randn(B, D, generator=g)
    out, c = roofline.count_step(f, w, x)
    assert torch.isfinite(out)
    assert c.dot_flops == want
    assert c.dot_flops == pytest.approx(jax_flops, rel=0.01)
    assert c.collective_bytes == 0 and c.bytes_accessed > 0
    r = roofline.roofline_from_costs(c, 1, float(want))
    assert r.compute_s == want / roofline.PEAK_FLOPS
    assert r.useful_fraction == 1.0 and r.dominant in ("compute", "memory")
    assert set(r.to_dict()) >= {"compute_s", "memory_s", "collective_s",
                                "dominant", "mfu", "useful_fraction",
                                "step_time_s", "collective_detail"}


_MESH_PROBE = textwrap.dedent("""
    import json, torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.dryrun import fake_dtensor, init_fake_world
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.roofline import count_step
    from repro_torch.sharding.rules import NamedSharding, P
    init_fake_world(4)
    mesh = make_local_mesh(2, 2, device_type="cpu")
    B, D, F = 64, 128, 256
    with FakeTensorMode():
        x = fake_dtensor((B, D), torch.float32,
                         NamedSharding(mesh, P(), (Replicate(), Replicate())),
                         "cpu")
        w = fake_dtensor((D, F), torch.float32,
                         NamedSharding(mesh, P(None, "model"),
                                       (Replicate(), Shard(1))), "cpu")
        y, c = count_step(lambda a, b: a @ b, x, w)
        z, c2 = count_step(lambda t: t.redistribute(
            mesh, [Replicate(), Replicate()]), y)
    print(json.dumps({"flops": c.dot_flops, "placements": str(y.placements),
                      "gather": c2.collective_detail, "local": list(
                          y.to_local().shape)}))
""")


def test_column_parallel_matmul_counts_one_rank():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _MESH_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    B, D, F = 64, 128, 256
    assert res["flops"] == 2 * B * D * F / 2
    assert res["local"] == [B, F // 2]
    # gathering the (B, F/2) float32 shards over the 2-way model axis
    assert res["gather"] == {"all-gather": B * F * 4 * (2 - 1) / 2}
