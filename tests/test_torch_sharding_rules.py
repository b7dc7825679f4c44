"""The port's sharding rules and local collectives against the JAX
package's: ``logical_to_pspec`` for every parameter leaf of every arch
on the production meshes {data: 16, model: 16} and {pod: 2, data: 16,
model: 16}, under every variant's policy (exact), the reference's four
rule cases, and ``quantize_roundtrip`` and ``ef_correct`` bit for bit
(float32 inputs from a numpy seed)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jconfig  # noqa: E402
from repro.launch.variants import VARIANTS as JVARIANTS  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.sharding import collectives as jcoll  # noqa: E402
from repro.sharding.rules import ShardingPolicy as JPolicy  # noqa: E402
from repro.sharding.rules import logical_to_pspec as jpspec  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.sharding import collectives  # noqa: E402
from repro_torch.sharding.rules import (  # noqa: E402
    DEFAULT_RULES,
    PartitionSpec,
    ShardingPolicy,
    is_spec,
    logical_to_pspec,
)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


def _leaves(specs, shapes, prefix=""):
    if is_spec(specs):
        yield prefix, specs, tuple(shapes.shape)
        return
    for k in specs:
        yield from _leaves(specs[k], shapes[k], f"{prefix}/{k}")


@pytest.mark.parametrize("arch", list_archs())
def test_every_leaf_translates_as_the_reference(arch):
    ref = jbuild(jconfig(arch))
    specs, shapes = ref.param_specs(), ref.param_shapes()
    leaves = list(_leaves(specs, shapes))
    policies = [(ShardingPolicy(), JPolicy())]
    for name, spec in JVARIANTS.items():
        if "policy" in spec:
            policies.append((ShardingPolicy().with_rules(name,
                                                         **spec["policy"]),
                             JPolicy().with_rules(name, **spec["policy"])))
    n = 0
    for mesh in MESHES:
        fm = FakeMesh(mesh)
        for pol, jpol in policies:
            for path, axes, shape in leaves:
                if axes is None:
                    continue
                got = logical_to_pspec(tuple(axes), shape, fm, pol)
                want = jpspec(tuple(axes), shape, fm, jpol)
                assert tuple(got) == tuple(want), (path, mesh, pol.name)
                n += 1
    assert n > 0


def test_logical_to_pspec_basic():
    mesh = FakeMesh({"data": 16, "model": 16})
    p = logical_to_pspec(("fsdp", "tp"), (1024, 4096), mesh, ShardingPolicy())
    assert p == PartitionSpec("data", "model")


def test_non_divisible_dim_dropped():
    mesh = FakeMesh({"data": 16, "model": 16})
    pol = ShardingPolicy()
    # 15 heads on 16-way model axis: constraint dropped (smollm case)
    p = logical_to_pspec(("batch", None, "heads", None), (256, 32, 15, 64),
                         mesh, pol)
    assert p == PartitionSpec("data")
    # kv_heads=8 not divisible by 16 either
    p2 = logical_to_pspec((None, "kv_heads"), (10, 8), mesh, pol)
    assert p2 == PartitionSpec()


def test_pod_axis_filtered_on_single_pod():
    mesh = FakeMesh({"data": 16, "model": 16})
    p = logical_to_pspec(("batch", None), (256, 128), mesh, ShardingPolicy())
    assert p == PartitionSpec("data")
    mesh2 = FakeMesh({"pod": 2, "data": 16, "model": 16})
    p2 = logical_to_pspec(("batch", None), (256, 128), mesh2,
                          ShardingPolicy())
    assert p2 == PartitionSpec(("pod", "data"))


def test_policy_override():
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    pol = ShardingPolicy().with_rules("fsdp_pods", fsdp=("pod", "data"))
    p = logical_to_pspec(("fsdp",), (64,), mesh, pol)
    assert p == PartitionSpec(("pod", "data"))
    assert pol.rules == dict(DEFAULT_RULES, fsdp=("pod", "data"))
    assert DEFAULT_RULES == JPolicy().rules


@pytest.mark.parametrize("n", [256, 4096, 1000, 3])
def test_quantize_roundtrip_bit_identical(n):
    import jax.numpy as jnp
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    x[: min(3, n)] *= 50.0
    got = collectives.quantize_roundtrip(torch.from_numpy(x)).numpy()
    want = np.asarray(jcoll.quantize_roundtrip(jnp.asarray(x)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_ef_correct_bit_identical():
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    g = rng.standard_normal(1000).astype(np.float32)
    e = (rng.standard_normal(1000) * 1e-3).astype(np.float32)
    c, new_err = collectives.ef_correct(torch.from_numpy(g),
                                        torch.from_numpy(e))
    jc, jnew = jcoll.ef_correct(jnp.asarray(g), jnp.asarray(e))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    t = collectives.quantize_roundtrip(c)
    jt = jcoll.quantize_roundtrip(jc)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(new_err(t).numpy(),
                                  np.asarray(jnew(jt)))
