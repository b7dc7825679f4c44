"""The port's prefill against the JAX package's, on the CPU: ``flash_attn``
(its plain blocked version, which the CPU runs, and its card route, one
``scaled_dot_product_attention``, run here on CPU tensors) against
``repro.models.attention.flash_attn``, and ``DecoderLM.prefill`` against
the JAX ``DecoderLM.prefill`` on shared weights (JAX ``init`` params
through ``state_to_tree`` into ``load_flat``).

Tolerances: attention outputs within 1e-5 in float32; logits within
atol/rtol 1e-4 in float32, as ``tests/test_torch_model.py`` holds; the
bfloat16 KV caches within one bfloat16 step of the larger magnitude
(2**-7 relative: the two packages round float32 values that differ in
their last bits); greedy tokens exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.attention import flash_attn as jax_flash  # noqa: E402
from repro.models.lm import RunFlags as JFlags  # noqa: E402
from repro.train.checkpoint import state_to_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import DecoderLM, RunFlags  # noqa: E402
from repro_torch.models.attention import flash_attn, \
    flash_attn_sdpa  # noqa: E402

CASES = [  # (B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, window, qb, kb)
    (2, 24, 24, 4, 2, 16, True, 0, 0, 512, 1024),
    (2, 24, 24, 4, 2, 16, False, 0, 0, 512, 1024),
    (1, 24, 24, 6, 2, 8, True, 0, 5, 7, 10),       # window < S, odd blocks
    (2, 8, 24, 4, 4, 16, True, 16, 0, 3, 5),       # q_offset, no GQA
    (1, 10, 30, 8, 2, 16, True, 20, 6, 4, 7),      # offset + window + GQA
    (1, 16, 16, 4, 1, 32, False, 0, 4, 16, 16),    # window, not causal
]


def _qkv(case, seed):
    B, Sq, Skv, Hq, Hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("i", range(len(CASES)))
def test_flash_attn_matches_jax(i):
    case = CASES[i]
    causal, off, window, qb, kb = case[6:]
    q, k, v = _qkv(case, seed=i)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, q_offset=off,
                                window=window, q_block=qb, kv_block=kb))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = flash_attn(tq, tk, tv, causal=causal, q_offset=off,
                       window=window, q_block=qb, kv_block=kb)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5, rtol=1e-5)
    card = flash_attn_sdpa(tq, tk, tv, causal=causal, q_offset=off,
                           window=window)
    np.testing.assert_allclose(card.numpy(), want, atol=1e-5, rtol=1e-5)


def _configs(arch):
    kw = {"sliding_window": 8} if arch == "starcoder2-15b" else {}
    return jax_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _pair(arch, seed=0):
    jcfg, tcfg = _configs(arch)
    jm = jax_build(jcfg, JFlags(dtype="float32"))
    params = jm.init(jax.random.key(seed))
    tm = DecoderLM(tcfg, RunFlags(dtype="float32"),
                   device="cpu").load_flat(state_to_tree(params))
    return jm, params, tm


def _bf16_close(got: torch.Tensor, want) -> None:
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    tol = 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w)) + 1e-30
    assert (np.abs(g - w) <= tol).all(), np.abs(g - w).max()


@pytest.mark.parametrize("arch", ["smollm-360m", "starcoder2-15b"])
def test_prefill_matches_jax_and_decode_continues(arch):
    jm, params, tm = _pair(arch)
    B, S, MAX = 2, 24, 32
    toks = np.random.default_rng(5).integers(0, jm.cfg.vocab_size, (B, S))
    jl, jst = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(
        toks, jnp.int32)}, jm.init_decode_state(B, MAX))
    tst = tm.init_decode_state(B, MAX)
    tst["g0"]["s0"]["k"].fill_(1.0)          # prefill overwrites all rows
    tl, tst = tm.prefill({"tokens": torch.from_numpy(toks)}, tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for name in ("k", "v"):
        _bf16_close(tst["g0"]["s0"][name], jst["g0"]["s0"][name])
    assert not tst["g0"]["s0"]["k"][:, :, S:].any()
    V = jm.cfg.vocab_size
    nxt = np.argmax(np.asarray(jl)[:, :V], -1)
    assert (tl[:, :V].argmax(-1).numpy() == nxt).all()
    pos = np.full(B, S)
    jd, _ = jax.jit(jm.decode_step)(params, jst, jnp.asarray(nxt, jnp.int32),
                                    jnp.asarray(pos, jnp.int32))
    td, _ = tm.decode_step(tst, torch.from_numpy(nxt), torch.from_numpy(pos))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4,
                               rtol=1e-4)
    assert (td[:, :V].argmax(-1).numpy()
            == np.argmax(np.asarray(jd)[:, :V], -1)).all()


@pytest.mark.parametrize("arch", ["smollm-360m", "starcoder2-15b"])
def test_prefill_equals_prefill_by_decode(arch):
    """The serving engine's route (one decode step per prompt token)
    reaches the prefill's last-position logits, window included. Float32
    caches: with the default bfloat16 ones the decode route attends to
    rounded keys and values and the prefill does not (~1e-3 apart)."""
    _, _, tm = _pair(arch, seed=1)
    B, S = 2, 20
    toks = np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (B, S))
    pl, _ = tm.prefill({"tokens": torch.from_numpy(toks)},
                       tm.init_decode_state(B, S, dtype=torch.float32))
    st = tm.init_decode_state(B, S, dtype=torch.float32)
    for t in range(S):
        dl, st = tm.decode_step(st, torch.from_numpy(toks[:, t]),
                                torch.full((B,), t))
    np.testing.assert_allclose(dl.numpy(), pl.numpy(), atol=1e-4, rtol=1e-4)
