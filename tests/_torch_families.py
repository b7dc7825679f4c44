"""Shared checks of the port's MoE, hybrid, xLSTM, VLM and
encoder-decoder families against the JAX package on the CPU
(``tests/test_torch_families*.py``, ``tests/test_torch_encdec.py``),
with the same weights: the JAX model's ``init`` params of
``jax.random.key(0)``
(jitted: a third of the eager init's time) through ``state_to_tree``
into ``load_flat``.

Tolerances, as ``tests/test_torch_model.py`` holds the dense family:
float32 logits within atol/rtol 1e-4, bfloat16 logits within 2e-2 of
max |logit|, greedy tokens exactly equal in float32. The float32 logit
comparison runs with float32 decode states: a bfloat16 cache rounds the
two packages' float32 keys, which differ in their last bits, to
neighbouring bfloat16 values now and then (reduced kimi, seed 0: 1.7e-4
after three decode steps with bfloat16 caches, 3.8e-7 with float32
ones). The engine runs with the default bfloat16 states, so a Mamba
window is promoted to float32 at the first step, as the JAX package's
is. A VLM's prefill takes random patch embeddings beside its tokens."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.lm import RunFlags as JFlags
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.train.checkpoint import state_to_tree
from repro_torch.configs import get_config
from repro_torch.models import RunFlags, build_model
from repro_torch.models.lm import F32_LEAVES, flat_specs, param_specs
from repro_torch.serve.engine import Request, ServeEngine

PROMPTS = [[5, 6, 7], [9, 9], [1, 200, 3, 17], [44]]


@functools.lru_cache(maxsize=None)
def jax_params(arch: str) -> tuple:
    """(flat, params) of the JAX init of `arch`'s reduced config."""
    jm = jax_build(jax_config(arch).reduced())
    params = jax.jit(jm.init)(jax.random.key(0))
    return state_to_tree(params), params


def port(arch: str, flat: dict, dtype: str):
    return build_model(get_config(arch).reduced(), RunFlags(dtype=dtype),
                       device="cpu").load_flat(flat)


def check_names_shapes_and_dtypes(arch: str, victim: str = "ffn/w_up"):
    """``load_flat`` takes exactly ``state_to_tree``'s names and shapes
    (raises on a missing, extra or misshapen one, here the first
    tensor whose name ends with `victim`) and keeps ``F32_LEAVES`` in
    float32 under bfloat16."""
    flat, _ = jax_params(arch)
    specs = flat_specs(param_specs(get_config(arch).reduced()))
    assert specs.keys() == flat.keys()
    for name, sp in specs.items():
        assert sp.shape == flat[name].shape, name
    tm = port(arch, flat, "bfloat16")
    for name, t in flat_specs(tm.params).items():
        leaf = name.rsplit("/", 1)[-1]
        want = torch.float32 if leaf in F32_LEAVES else torch.bfloat16
        assert t.dtype == want, name
    victim = next(n for n in sorted(flat) if n.endswith(victim))
    with pytest.raises(KeyError):
        tm.load_flat({k: v for k, v in flat.items() if k != victim})
    with pytest.raises(KeyError):
        tm.load_flat({**flat, "g9/s0/extra": np.zeros(1, np.float32)})
    with pytest.raises(ValueError):
        tm.load_flat({**flat, victim: flat[victim][..., :-1]})


def _close(got, want, dtype: str):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def check_prefill_and_decode_logits(arch: str, dtype: str):
    """A 5-token prefill, then three decode steps from its state."""
    flat, params = jax_params(arch)
    jm = jax_build(jax_config(arch).reduced(), JFlags(dtype=dtype))
    tm = port(arch, flat, dtype)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    B, S = 2, 5
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, 256, (B, S))}
    if tm.cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, tm.cfg.num_patches, tm.cfg.d_model), np.float32) * 0.02
    rows = S + (tm.cfg.num_patches if "patches" in batch else 0)
    jl, jst = jax.jit(jm.prefill)(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        jm.init_decode_state(B, 32, jdt))
    tl, tst = tm.prefill({k: torch.from_numpy(v) for k, v in batch.items()},
                         tm.init_decode_state(B, 32, tdt))
    _close(tl, jl, dtype)
    step = jax.jit(jm.decode_step)
    pos = np.full(B, rows)
    for _ in range(3):
        t = rng.integers(0, 256, B)
        jl, jst = step(params, jst, jnp.asarray(t, jnp.int32),
                       jnp.asarray(pos, jnp.int32))
        tl, tst = tm.decode_step(tst, torch.from_numpy(t),
                                 torch.from_numpy(pos))
        _close(tl, jl, dtype)
        pos = pos + 1


def check_engine_with_reused_slots(arch: str):
    """4 requests at batch 2, float32: requests 2 and 3 reuse the slots
    of 0 and 1, whose decode state neither engine resets (ROADMAP.md
    §3)."""
    flat, params = jax_params(arch)
    jm = jax_build(jax_config(arch).reduced(), JFlags(dtype="float32"))
    jeng = JEngine(jm, params, max_batch=2, max_len=32)
    jreqs = [JRequest(i, prompt=p, max_new=5) for i, p in enumerate(PROMPTS)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    eng = ServeEngine(port(arch, flat, "float32"), max_batch=2, max_len=32)
    reqs = [Request(i, prompt=p, max_new=5) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
