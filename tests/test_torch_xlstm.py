"""The port's xLSTM mixers (``repro_torch.models.xlstm``) against the JAX
package's on the CPU, with the same weights: the JAX ``mlstm_init`` and
``slstm_init`` of ``jax.random.key(0)`` for reduced xlstm-350m (d_model
64, 4 heads, m_inner 128, d_conv 4, sLSTM FFN 128) carried across as
numpy.

Each mixer's sequence path with ``chunk`` 4 and 256 (the JAX package's
backward grouping; the forward is the same recurrence) and its final
state, decoding step by step from that state, and decoding every token
from the zero state against the sequence path. Tolerance: 1e-5 absolute
in float32. Also the init rules' constants (``b_if``, ``b``,
``norm_scale``) and statistics (``conv_w``, ``r``), and the repaired
short sLSTM prefill: after a prefill of fewer than d_conv - 1 tokens the
JAX package's next decode step raises, while the port's continues
exactly as decoding every token would."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.models.lm import F32_LEAVES, flat_specs, init_device, \
    init_flat, param_specs  # noqa: E402

ATOL = 1e-5
ARCH = "xlstm-350m"
MIXERS = ("mlstm", "slstm")
_apply = {m: jax.jit(getattr(jx, f"{m}_apply"), static_argnums=(2, 3),
                     static_argnames=("chunk", "return_state"))
          for m in MIXERS}
_decode = {m: jax.jit(getattr(jx, f"{m}_decode"), static_argnums=(3, 4))
           for m in MIXERS}


@pytest.fixture(scope="module")
def pair():
    """{mixer: (JAX params, port params)} and the two configs."""
    jcfg = jax_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    out = {}
    for m in MIXERS:
        p, _ = getattr(jx, f"{m}_init")(jax.random.key(0), m, jcfg)
        out[m] = (p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    return jcfg, tcfg, out


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=0)


def _port_state(m, tcfg, batch):
    if m == "mlstm":
        return xlstm.mlstm_decode_state(tcfg, batch)
    return xlstm.slstm_decode_state(tcfg, batch, torch.float32)


def _jax_state(m, jcfg, batch):
    if m == "mlstm":
        return jx.mlstm_decode_state(jcfg, batch)
    return jx.slstm_decode_state(jcfg, batch, jnp.float32)


def _close_states(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in got:
        _close(got[k], want[k])


def test_shapes_and_init_rules(pair):
    """``b_if``, ``b`` and ``norm_scale`` equal the JAX constants; the
    port's draws of ``conv_w`` (0.2) and ``r`` (1/sqrt(hd)) have the
    reference's scale; ``b_if``, ``b`` and ``r`` stay float32 under
    bfloat16, ``norm_scale`` does not."""
    jcfg, tcfg, ps = pair
    assert xlstm.m_inner(tcfg) == jx.m_inner(jcfg) == 128
    assert xlstm.slstm_ff(tcfg) == 128
    assert xlstm.slstm_ff(get_config(ARCH)) == 1408
    full = get_config(ARCH)
    cfg = full.reduced(d_model=256, num_heads=2, num_kv_heads=2, d_ff=0)
    for init in ("init_flat", "init_device"):
        flat = init_flat(cfg, 1) if init == "init_flat" else \
            init_device(cfg, 1, "bfloat16", device="cpu")
        flat = {k: torch.as_tensor(v) for k, v in flat.items()}
        for m in MIXERS:
            jp, _ = getattr(jx, f"{m}_init")(jax.random.key(0), m,
                                              jax_config(ARCH).reduced(
                                                  d_model=256, num_heads=2,
                                                  num_kv_heads=2, d_ff=0))
            for leaf in ("b_if", "norm_scale") if m == "mlstm" else ("b",):
                got = flat[f"g0/s{MIXERS.index(m)}/mixer/{leaf}"]
                want = np.broadcast_to(np.asarray(jp[leaf]), got.shape)
                np.testing.assert_array_equal(got.float().numpy(), want)
                f32 = leaf in F32_LEAVES
                assert (got.dtype == torch.float32) == (
                    f32 or init == "init_flat"), leaf
        conv = flat["g0/s1/mixer/conv_w"].float()
        r = flat["g0/s1/mixer/r"].float()
        assert abs(float(conv.std()) - 0.2) < 0.02
        hd = cfg.d_model // cfg.num_heads
        assert abs(float(r.std()) * np.sqrt(hd) - 1.0) < 0.05
        assert flat["g0/s1/mixer/ff_up"].shape == (1, 256, 384)
    specs = flat_specs(param_specs(full))
    assert specs["g0/s1/mixer/ff_up"].shape == (12, 1024, 1408)
    assert specs["g0/s1/mixer/r"].shape == (12, 4, 4, 256, 256)
    assert specs["g0/s0/mixer/wq"].shape == (12, 2048, 2048)


@pytest.mark.parametrize("mixer", MIXERS)
@pytest.mark.parametrize("chunk", [4, 256])
def test_sequence_path_and_state_match_jax(pair, mixer, chunk):
    jcfg, tcfg, ps = pair
    p, tp = ps[mixer]
    x = _x((2, 12, 64), chunk)
    want, wst = _apply[mixer](p, jnp.asarray(x), jcfg, jnp.float32,
                              chunk=chunk, return_state=True)
    apply = getattr(xlstm, f"{mixer}_apply")
    got, gst = apply(tp, torch.from_numpy(x), tcfg, torch.float32,
                     chunk=chunk, return_state=True)
    _close(got, want)
    _close_states(gst, wst)
    plain = apply(tp, torch.from_numpy(x), tcfg, torch.float32, chunk=3)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("mixer", MIXERS)
def test_decode_steps_match_jax(pair, mixer):
    jcfg, tcfg, ps = pair
    p, tp = ps[mixer]
    x = _x((2, 6, 64), 3)
    _, wst = _apply[mixer](p, jnp.asarray(x), jcfg, jnp.float32, chunk=256,
                           return_state=True)
    _, gst = getattr(xlstm, f"{mixer}_apply")(
        tp, torch.from_numpy(x), tcfg, torch.float32, return_state=True)
    decode = getattr(xlstm, f"{mixer}_decode")
    for xt in _x((5, 2, 64), 4):
        want, wst = _decode[mixer](p, jnp.asarray(xt), wst, jcfg,
                                   jnp.float32)
        got, gst = decode(tp, torch.from_numpy(xt), gst, tcfg, torch.float32)
        _close(got, want)
        _close_states(gst, wst)


@pytest.mark.parametrize("mixer", MIXERS)
def test_decode_from_zero_state_equals_the_sequence_path(pair, mixer):
    """Decoding every token from the zero state gives the sequence
    path's outputs and final state (both packages)."""
    jcfg, tcfg, ps = pair
    p, tp = ps[mixer]
    x = _x((2, 7, 64), 5)
    seq, sst = getattr(xlstm, f"{mixer}_apply")(
        tp, torch.from_numpy(x), tcfg, torch.float32, return_state=True)
    decode = getattr(xlstm, f"{mixer}_decode")
    st, jst = _port_state(mixer, tcfg, 2), _jax_state(mixer, jcfg, 2)
    for t in range(7):
        y, st = decode(tp, torch.from_numpy(x[:, t]), st, tcfg, torch.float32)
        jy, jst = _decode[mixer](p, jnp.asarray(x[:, t]), jst, jcfg,
                                 jnp.float32)
        _close(y, seq[:, t])
        _close(jy, seq[:, t])
    _close_states(st, sst)


def test_short_slstm_prefill_then_decode(pair):
    """A 2-token prefill (d_conv - 1 = 3): the JAX package's window is
    ``x[:, S - 3:]``, whose start -1 wraps to the last row, so it holds
    1 row and its decode raises; the port's holds 3, the first zero, and
    prefill + decode equals decoding all three tokens."""
    jcfg, tcfg, ps = pair
    p, tp = ps["slstm"]
    x = _x((2, 3, 64), 6)
    _, wst = _apply["slstm"](p, jnp.asarray(x[:, :2]), jcfg, jnp.float32,
                             chunk=256, return_state=True)
    assert wst["conv"].shape == (2, 1, 64)
    with pytest.raises(ValueError):
        jx.slstm_decode(p, jnp.asarray(x[:, 2]), wst, jcfg, jnp.float32)

    _, st = xlstm.slstm_apply(tp, torch.from_numpy(x[:, :2]), tcfg,
                              torch.float32, return_state=True)
    assert st["conv"].shape == (2, 3, 64)
    assert not st["conv"][:, 0].any()
    y, st = xlstm.slstm_decode(tp, torch.from_numpy(x[:, 2]), st, tcfg,
                               torch.float32)
    ref = _port_state("slstm", tcfg, 2)
    for t in range(3):
        ry, ref = xlstm.slstm_decode(tp, torch.from_numpy(x[:, t]), ref,
                                     tcfg, torch.float32)
    _close(y, ry)
    _close_states(st, ref)


def test_bfloat16_slstm_window_promotes_under_float32(pair):
    """A bfloat16 sLSTM window decoded by a float32 mixer comes back
    float32, as the JAX package's concatenation promotes it."""
    jcfg, tcfg, ps = pair
    p, tp = ps["slstm"]
    st = xlstm.slstm_decode_state(tcfg, 2, torch.bfloat16)
    jst = jx.slstm_decode_state(jcfg, 2, jnp.bfloat16)
    x = _x((2, 64), 7)
    y, st = xlstm.slstm_decode(tp, torch.from_numpy(x), st, tcfg,
                               torch.float32)
    jy, jst = _decode["slstm"](p, jnp.asarray(x), jst, jcfg, jnp.float32)
    assert st["conv"].dtype == torch.float32
    assert jst["conv"].dtype == jnp.float32
    _close(y, jy)
    _close_states(st, jst)
