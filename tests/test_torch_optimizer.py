"""The port's AdamW (``repro_torch.train.optimizer``) against the JAX
package's on the CPU: five updates of the same params with the same
seeded gradients through both, for float32, bfloat16 and int8 moments;
then the JAX package's own optimizer cases (``tests/test_optimizer_moe_ssm.py``
``TestAdamW``: convergence in each mode, the clipped step, the int8
state's size) on the port.

Tolerances: the two packages' float32 arithmetic differs only in the
last bits (the JAX package's ``b ** step`` and its fused ops), so after
five steps params and float32 moments lie within 1e-6 of each tensor's
max magnitude, the global norm within 1e-6 relative; bfloat16 moments
within one bfloat16 step (their bit patterns at most 1 apart); int8
moments with the JAX shapes (rows padded to 512), ``q`` at most 1 apart
in at most 0.1% of the entries (a last-bit difference can cross a
rounding midpoint), ``scale`` within 1e-6 relative; ``step`` an int32
scalar equal to the JAX one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train.optimizer import OptConfig as JOpt  # noqa: E402
from repro.train.optimizer import adamw_update as jax_update  # noqa: E402
from repro.train.optimizer import init_opt_state as jax_init  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    OptConfig,
    adamw_update,
    global_norm,
    init_opt_state,
)

SHAPES = {"a": (300, 7), "b/c": (5,), "b/d": (2, 3, 256)}


def _tree(rng, scale=1.0) -> dict:
    flat = {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}
    return {"a": flat["a"], "b": {"c": flat["b/c"], "d": flat["b/d"]}}


def _close(got, want, rel=1e-6):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def _leaves(tree, is_moment=False):
    if isinstance(tree, dict) and not (is_moment and "q" in tree):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_moment)]
    return [tree]


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_matches_jax(moments):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    jcfg, tcfg = JOpt(moments=moments), OptConfig(moments=moments)
    js, ts = jax_init(jp, jcfg), init_opt_state(tp, tcfg)
    for step in range(5):
        g = _tree(rng, scale=10.0 ** (step - 2))   # clipped and not
        jp, js, jgn = jax_update(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, tgn = adamw_update(tp, jax.tree.map(torch.from_numpy, g),
                                   ts, tcfg)
        assert abs(tgn.item() - float(jgn)) <= 1e-6 * float(jgn)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    assert int(ts["step"]) == int(js["step"]) == 5
    for a, b in zip(_leaves(tp), _leaves(jp)):
        assert a.dtype == torch.float32
        _close(a.numpy(), b)
    for key in ("m", "v"):
        for a, b in zip(_leaves(ts[key], True), _leaves(js[key], True)):
            if moments == "float32":
                _close(a.numpy(), b)
            elif moments == "bfloat16":
                assert a.dtype == torch.bfloat16
                bits = a.view(torch.int16).numpy().view(np.uint16)
                want = np.asarray(b).view(np.uint16)
                assert bits.shape == want.shape
                assert np.abs(bits.astype(np.int32)
                              - want.astype(np.int32)).max() <= 1
            else:
                q, wq = a["q"].numpy(), np.asarray(b["q"])
                assert q.dtype == np.int8 and q.shape == wq.shape
                diff = np.abs(q.astype(np.int32) - wq.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
                assert a["scale"].shape == b["scale"].shape
                _close(a["scale"].numpy(), b["scale"])


def test_global_norm_matches_jax():
    from repro.train.optimizer import global_norm as jax_norm
    tree = _tree(np.random.default_rng(3))
    want = float(jax_norm(jax.tree.map(jnp.asarray, tree)))
    got = global_norm(jax.tree.map(torch.from_numpy, tree)).item()
    assert abs(got - want) <= 1e-6 * want


def _converge(moments, steps=50) -> float:
    params = {"w": torch.zeros(64)}
    cfg = OptConfig(lr=0.1, weight_decay=0.0, moments=moments)
    opt = init_opt_state(params, cfg)
    for _ in range(steps):
        g = {"w": 2.0 * (params["w"] - 3.0)}
        params, opt, _ = adamw_update(params, g, opt, cfg)
    return float((params["w"] - 3.0).abs().mean())


@pytest.mark.parametrize("moments,bound", [("float32", 0.5), ("int8", 0.6),
                                           ("bfloat16", 0.6)])
def test_converges(moments, bound):
    assert _converge(moments) < bound


def test_grad_clip():
    params = {"w": torch.zeros(4)}
    cfg = OptConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    opt = init_opt_state(params, cfg)
    new, opt, gn = adamw_update(params, {"w": torch.full((4,), 1e6)}, opt,
                                cfg)
    assert float(gn) > 1e5
    assert float(new["w"].abs().max()) < 2.0        # clipped step


def test_int8_state_is_smaller():
    params = {"w": torch.zeros((2048, 1024))}
    s32 = init_opt_state(params, OptConfig(moments="float32"))
    s8 = init_opt_state(params, OptConfig(moments="int8"))

    def nbytes(tree):
        return sum(x.numel() * x.element_size()
                   for x in _leaves({k: tree[k] for k in ("m", "v")}, True)
                   for x in ([x["q"], x["scale"]] if isinstance(x, dict)
                             else [x]))
    assert nbytes(s8) < nbytes(s32) / 3
