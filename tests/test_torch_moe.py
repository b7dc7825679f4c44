"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``moe_apply`` on the CPU, with the same weights: the JAX
``moe_init`` of ``jax.random.key(0)`` carried across as numpy.

Configs: reduced arctic-480b (dense residual MLP), kimi-k2-1t-a32b
(a shared expert) and jamba-v0.1-52b (plain top-2). Cases: a batch
whose assignments overflow the capacity (``capacity_factor`` 0.5), 256
tokens (capacity 160 rounds up to 256), and routers whose
probabilities tie exactly, which ``jax.lax.top_k`` breaks toward the
lower index. Tolerance: 1e-5 absolute in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.moe import moe_apply as jax_moe  # noqa: E402
from repro.models.moe import moe_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["arctic-480b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"]
ATOL = 1e-5
# one compile per config and shape (eager jnp compiles every op anew)
_jax_moe = jax.jit(jax_moe, static_argnums=(2, 3))


def _pair(arch, **overrides):
    jcfg = jax_config(arch).reduced(**overrides)
    tcfg = get_config(arch).reduced(**overrides)
    p, _ = moe_init(jax.random.key(0), "moe", jcfg)
    return jcfg, tcfg, p


def _to_torch(p):
    if isinstance(p, dict):
        return {k: _to_torch(v) for k, v in p.items()}
    return torch.from_numpy(np.array(p))


def _check(jcfg, tcfg, p, x):
    want = np.asarray(_jax_moe(p, jnp.asarray(x), jcfg, jnp.float32))
    got = moe.moe_apply(_to_torch(p), torch.from_numpy(x), tcfg,
                        torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    return got


def _kept(tcfg, p, x):
    """Assignments kept under the capacity, and all of them."""
    xf = torch.from_numpy(x).reshape(-1, x.shape[-1])
    _, experts = moe.route(_to_torch(p), xf, tcfg, torch.float32)
    cap = moe.capacity(tcfg, xf.shape[0])
    counts = torch.bincount(experts.reshape(-1),
                            minlength=tcfg.num_experts)
    return int(torch.clamp(counts, max=cap).sum()), experts.numel()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_drops_assignments_past_capacity(arch):
    jcfg, tcfg, p = _pair(arch, capacity_factor=0.5)
    x = np.random.default_rng(1).standard_normal((2, 8, 64), np.float32)
    kept, total = _kept(tcfg, p, x)
    assert moe.capacity(tcfg, 16) == 4 and kept < total
    _check(jcfg, tcfg, p, x)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_256_tokens_round_capacity_up_to_128s(arch):
    jcfg, tcfg, p = _pair(arch)
    assert moe.capacity(tcfg, 256) == 256       # 160 -> 256
    assert moe.capacity(tcfg, 64) == 40         # below 128: not rounded
    x = np.random.default_rng(2).standard_normal((4, 64, 64), np.float32)
    _check(jcfg, tcfg, p, x)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_one_token_and_decode_batch(arch):
    jcfg, tcfg, p = _pair(arch)
    rng = np.random.default_rng(3)
    for shape in ((1, 1, 64), (4, 1, 64), (3, 5, 64)):
        _check(jcfg, tcfg, p, rng.standard_normal(shape, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_router_ties_break_to_the_lower_expert(arch):
    """Experts 1, 2 and 3 share one router column, so their
    probabilities are equal for every token: top-2 is (0, 1) where
    expert 0 leads and (1, 2) where it trails."""
    jcfg, tcfg, p = _pair(arch)
    router = np.array(p["router"])
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 1]
    p = dict(p, router=jnp.asarray(router))
    x = np.random.default_rng(4).standard_normal((2, 12, 64), np.float32)
    xf = torch.from_numpy(x).reshape(-1, 64)
    _, experts = moe.route(_to_torch(p), xf, tcfg, torch.float32)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, 64)) @ p["router"], -1)
    _, want = jax.lax.top_k(probs, 2)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(want))
    pairs = {tuple(e) for e in experts.tolist()}
    assert pairs == {(0, 1), (1, 2)}
    _check(jcfg, tcfg, p, x)


def test_top_k_ties_match_jax_top_k():
    x = np.random.default_rng(5).integers(0, 4, (64, 16)).astype(np.float32)
    for k in (1, 2, 5, 16):
        vals, idx = moe.top_k(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_moe_gelu_experts():
    """A GeLU config (no ``w_gate``): the tanh GeLU of the JAX
    package's experts."""
    jcfg, tcfg, p = _pair("arctic-480b", mlp_type="gelu")
    assert "w_gate" not in p
    x = np.random.default_rng(6).standard_normal((2, 6, 64), np.float32)
    _check(jcfg, tcfg, p, x)


def test_combine_is_bitwise_repeatable():
    """Two calls on the same input give the same bits (no atomics)."""
    _, tcfg, p = _pair("kimi-k2-1t-a32b")
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.75)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, 32, 64), np.float32))
    a = moe.moe_apply(_to_torch(p), x, tcfg, torch.float32)
    b = moe.moe_apply(_to_torch(p), x, tcfg, torch.float32)
    assert torch.equal(a, b)
