"""The port's Mamba mixer (``repro_torch.models.mamba``) against the JAX
package's on the CPU, with the same weights: the JAX ``mamba_init`` of
``jax.random.key(0)`` for reduced jamba-v0.1-52b (d_model 64, d_inner
128, d_state 8, d_conv 4, dt_rank 4) carried across as numpy.

The sequence path with ``chunk`` 2 and 16 (the JAX package's backward
grouping; the forward is the same recurrence) and its final state, and
decoding step by step from that state. Tolerance: 1e-5 absolute in
float32. Also the repaired short prefill: after a prefill of fewer than
d_conv - 1 tokens the JAX package's next decode step raises, while the
port's continues exactly as decoding every token would."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mamba  # noqa: E402

ATOL = 1e-5
_apply = jax.jit(jmamba.mamba_apply, static_argnums=(2, 3),
                 static_argnames=("chunk", "return_state"))
_decode = jax.jit(jmamba.mamba_decode, static_argnums=(3, 4))


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_config("jamba-v0.1-52b").reduced()
    tcfg = get_config("jamba-v0.1-52b").reduced()
    p, _ = jmamba.mamba_init(jax.random.key(0), "mamba", jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return jcfg, tcfg, p, tp


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=0)


def test_shapes_and_init_rules(pair):
    jcfg, tcfg, p, _ = pair
    assert mamba.d_inner(tcfg) == jmamba.d_inner(jcfg) == 128
    assert mamba.dt_rank(tcfg) == jmamba._dt_rank(jcfg) == 4
    assert p["A_log"].dtype == jnp.float32


@pytest.mark.parametrize("chunk", [2, 16])
def test_sequence_path_and_state_match_jax(pair, chunk):
    jcfg, tcfg, p, tp = pair
    x = _x((2, 16, 64), chunk)
    want, wst = _apply(p, jnp.asarray(x), jcfg, jnp.float32, chunk=chunk,
                       return_state=True)
    got, gst = mamba.mamba_apply(tp, torch.from_numpy(x), tcfg,
                                 torch.float32, chunk=chunk,
                                 return_state=True)
    _close(got, want)
    _close(gst["conv"], wst["conv"])
    _close(gst["ssm"], wst["ssm"])
    assert gst["ssm"].dtype == torch.float32
    plain = mamba.mamba_apply(tp, torch.from_numpy(x), tcfg, torch.float32)
    assert torch.equal(plain, got)


def test_decode_steps_match_jax(pair):
    jcfg, tcfg, p, tp = pair
    x = _x((2, 6, 64), 3)
    _, wst = _apply(p, jnp.asarray(x), jcfg, jnp.float32, chunk=64,
                    return_state=True)
    _, gst = mamba.mamba_apply(tp, torch.from_numpy(x), tcfg, torch.float32,
                               return_state=True)
    for t, xt in enumerate(_x((5, 2, 64), 4)):
        want, wst = _decode(p, jnp.asarray(xt), wst, jcfg, jnp.float32)
        got, gst = mamba.mamba_decode(tp, torch.from_numpy(xt), gst, tcfg,
                                      torch.float32)
        _close(got, want)
        _close(gst["conv"], wst["conv"])
        _close(gst["ssm"], wst["ssm"])


def test_decode_from_zero_state_equals_the_sequence_path(pair):
    """Decoding every token from the zero state gives the sequence
    path's outputs and final state (both packages)."""
    jcfg, tcfg, p, tp = pair
    x = _x((2, 5, 64), 5)
    seq, sst = mamba.mamba_apply(tp, torch.from_numpy(x), tcfg,
                                 torch.float32, return_state=True)
    st = mamba.mamba_decode_state(tcfg, 2, torch.float32)
    jst = jmamba.mamba_decode_state(jcfg, 2, jnp.float32)
    for t in range(5):
        y, st = mamba.mamba_decode(tp, torch.from_numpy(x[:, t]), st, tcfg,
                                   torch.float32)
        jy, jst = _decode(p, jnp.asarray(x[:, t]), jst, jcfg, jnp.float32)
        _close(y, seq[:, t])
        _close(jy, seq[:, t])
    _close(st["conv"], sst["conv"])
    _close(st["ssm"], sst["ssm"])


def test_short_prefill_then_decode(pair):
    """A 2-token prefill (d_conv - 1 = 3): the JAX package's window is
    ``xi_raw[:, S - 3:]``, whose start -1 wraps to the last row, so it
    holds 1 row and its decode raises; the port's holds 3, the first
    zero, and prefill + decode equals decoding all three tokens."""
    jcfg, tcfg, p, tp = pair
    x = _x((2, 3, 64), 6)
    _, wst = _apply(p, jnp.asarray(x[:, :2]), jcfg, jnp.float32, chunk=64,
                    return_state=True)
    assert wst["conv"].shape == (2, 1, 128)
    with pytest.raises(ValueError):
        jmamba.mamba_decode(p, jnp.asarray(x[:, 2]), wst, jcfg, jnp.float32)

    _, st = mamba.mamba_apply(tp, torch.from_numpy(x[:, :2]), tcfg,
                              torch.float32, return_state=True)
    assert st["conv"].shape == (2, 3, 128)
    assert not st["conv"][:, 0].any()
    y, st = mamba.mamba_decode(tp, torch.from_numpy(x[:, 2]), st, tcfg,
                               torch.float32)
    ref = mamba.mamba_decode_state(tcfg, 2, torch.float32)
    for t in range(3):
        ry, ref = mamba.mamba_decode(tp, torch.from_numpy(x[:, t]), ref,
                                     tcfg, torch.float32)
    _close(y, ry)
    _close(st["conv"], ref["conv"])
    _close(st["ssm"], ref["ssm"])


def test_bfloat16_window_promotes_under_float32(pair):
    """A bfloat16 window decoded by a float32 mixer comes back float32,
    as the JAX package's concatenation promotes it."""
    jcfg, tcfg, p, tp = pair
    st = mamba.mamba_decode_state(tcfg, 2, torch.bfloat16)
    jst = jmamba.mamba_decode_state(jcfg, 2, jnp.bfloat16)
    x = _x((2, 64), 7)
    y, st = mamba.mamba_decode(tp, torch.from_numpy(x), st, tcfg,
                               torch.float32)
    jy, jst = _decode(p, jnp.asarray(x), jst, jcfg, jnp.float32)
    assert st["conv"].dtype == torch.float32
    assert jst["conv"].dtype == jnp.float32
    _close(y, jy)
    _close(st["conv"], jst["conv"])
