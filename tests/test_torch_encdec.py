"""The port's encoder-decoder family (reduced whisper-base: 2 encoder and
2 decoder layers, biases, layernorm, sinusoidal positions, GeLU MLPs)
against the JAX ``EncDecModel`` on the CPU, with the same weights (the
JAX ``init`` of ``jax.random.key(0)`` through ``state_to_tree`` into
``load_flat``): the parameter names, shapes and dtypes, ``encode``, the
training loss and every gradient against ``jax.value_and_grad``
(``tests/_torch_train.py``: loss within 1e-5, gradients within 1e-4 of
each tensor's max |g|; the attention key biases, whose gradients are
zero in exact arithmetic, within 1e-6 of the largest gradient in both
packages), ``prefill`` (the cross k/v and the summary
logits of the mean-pooled encoder output) then three decode steps, in
float32 (1e-4) and bfloat16 (2e-2 of max |logit|), the serving engine
(which decodes against the zero cross k/v of ``init_decode_state``, as
the JAX engine does), and a JAX ``create_image`` of the params
cold-started by the port: every tensor byte-equal, the engine's tokens
the JAX engine's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_families as fam  # noqa: E402
from _torch_train import check_against_jax  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.loader import create_image  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.lm import RunFlags as JFlags  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.service import ImageService, ServiceConfig  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.models import EncDecModel, RunFlags, build_model  # noqa: E402
from repro_torch.serve.coldstart import cold_start  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402
from repro_torch.train.checkpoint import \
    state_to_tree as port_state_to_tree  # noqa: E402

ARCH = "whisper-base"
KEY = b"W" * 32


def _frames(B=2, S=12, seed=4):
    cfg = get_config(ARCH).reduced()
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model), np.float32) * 0.1


def test_load_flat_takes_exactly_the_jax_names_and_shapes():
    fam.check_names_shapes_and_dtypes(ARCH)
    flat, _ = fam.jax_params(ARCH)
    assert flat["enc/s0/mixer/wq"].shape == (2, 64, 64)
    assert flat["dec/s1/mixer/bo"].shape == (2, 64)
    assert {"enc_norm/scale", "enc_norm/bias", "final_norm/bias"} <= set(flat)
    assert isinstance(build_model(get_config(ARCH).reduced(), device="cpu"),
                      EncDecModel)


def test_encode_matches_jax():
    flat, params = fam.jax_params(ARCH)
    jm = jax_build(jax_config(ARCH).reduced(), JFlags(dtype="float32"))
    tm = fam.port(ARCH, flat, "float32")
    x = _frames()
    want = jax.jit(jm.encode, static_argnums=2)(params, jnp.asarray(x),
                                                jnp.float32)
    got = tm.encode(tm.params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_loss_and_grads_match_jax():
    check_against_jax(ARCH, "float32", zero_grads=("mixer/bk",))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    flat, params = fam.jax_params(ARCH)
    jm = jax_build(jax_config(ARCH).reduced(), JFlags(dtype=dtype))
    tm = fam.port(ARCH, flat, dtype)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    B, x = 2, _frames()
    jl, jst = jax.jit(jm.prefill)(params, {"frames": jnp.asarray(x)},
                                  jm.init_decode_state(B, 16, jdt))
    tl, tst = tm.prefill({"frames": torch.from_numpy(x)},
                         tm.init_decode_state(B, 16, tdt))
    fam._close(tl, jl, dtype)
    for k in ("k", "v"):
        assert tst["s1"][k].shape == jst["s1"][k].shape == (2, B, 12, 2, 16)
        assert tst["s1"][k].dtype == tdt
        fam._close(tst["s1"][k], jst["s1"][k], dtype)
    step = jax.jit(jm.decode_step)
    rng = np.random.default_rng(5)
    pos = np.zeros(B, np.int64)
    for _ in range(3):
        t = rng.integers(0, 256, B)
        jl, jst = step(params, jst, jnp.asarray(t, jnp.int32),
                       jnp.asarray(pos, jnp.int32))
        tl, tst = tm.decode_step(tst, torch.from_numpy(t),
                                 torch.from_numpy(pos))
        fam._close(tl, jl, dtype)
        pos = pos + 1


def test_engine_tokens_with_reused_slots_match_jax():
    fam.check_engine_with_reused_slots(ARCH)


def test_cold_start_from_jax_image(tmp_path):
    """A JAX ``create_image`` of the params, cold-started by the port
    (``torch-fused``'s plain version here): every tensor byte-equal to
    the JAX tree, and the engine's greedy tokens the JAX engine's."""
    flat, params = fam.jax_params(ARCH)
    jm = jax_build(jax_config(ARCH).reduced(), JFlags(dtype="float32"))
    jeng = JEngine(jm, params, max_batch=2, max_len=32)
    jreqs = [JRequest(i, prompt=p, max_new=4)
             for i, p in enumerate(fam.PROMPTS[:2])]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    blob, _ = create_image(flat, tenant="t", tenant_key=KEY,
                           store=JStore(tmp_path / "s"), root="r0",
                           chunk_size=4096)
    svc = ImageService(ChunkStore(tmp_path / "s"), ServiceConfig(device="cpu"))
    model = build_model(get_config(ARCH).reduced(), RunFlags(dtype="float32"),
                        device="cpu")
    engine, stats = cold_start(model, blob, KEY, svc, max_batch=2,
                               max_len=32)
    svc.close()
    assert stats["decode_backend"] == "torch-fused"
    got = port_state_to_tree(model.params)
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        assert got[k].tobytes() == np.asarray(v).tobytes(), k
    reqs = [Request(i, prompt=p, max_new=4)
            for i, p in enumerate(fam.PROMPTS[:2])]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert [r.out for r in reqs] == [r.out for r in jreqs]
