"""The port's dense decoder and serving path against the JAX package's,
on the CPU, with identical weights: JAX params from ``model.init`` go
through ``state_to_tree`` into ``DecoderLM.load_flat``.

Tolerances: float32 logits within atol 1e-4 / rtol 1e-4 (the same
algorithm, summed in another order); bfloat16 logits within 2e-2 of
max |logit| (the two frameworks round bfloat16 at different places);
greedy tokens exactly equal in float32 (random bfloat16 weights can tie
at the argmax, so bfloat16 is held by the logit tolerance only)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.loader import create_image  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.lm import RunFlags as JFlags  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.train.checkpoint import state_to_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.service import ImageService, ServiceConfig  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.models import DecoderLM, RunFlags  # noqa: E402
from repro_torch.serve.coldstart import cold_start  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train.checkpoint import \
    state_to_tree as port_state_to_tree  # noqa: E402

ARCHS = ["smollm-360m", "tinyllama-1.1b"]
PROMPTS = [[5, 6, 7], [9, 9], [1, 200, 3, 17]]


def _pair(arch, dtype, seed=0):
    jcfg = jax_config(arch).reduced()
    jm = build_model(jcfg, JFlags(dtype=dtype))
    params = jm.init(jax.random.key(seed))
    flat = state_to_tree(params)
    tm = DecoderLM(get_config(arch).reduced(), RunFlags(dtype=dtype),
                   device="cpu").load_flat(flat)
    return jm, params, flat, tm


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_logits_match_jax(arch, dtype):
    jm, params, _, tm = _pair(arch, dtype)
    step = jax.jit(jm.decode_step)
    jst = jm.init_decode_state(2, 16)
    tst = tm.init_decode_state(2, 16)
    rng = np.random.default_rng(7)
    pos = np.array([0, 0])
    for _ in range(5):
        toks = rng.integers(0, jm.cfg.vocab_size, 2)
        jl, jst = step(params, jst, jnp.asarray(toks, jnp.int32),
                       jnp.asarray(pos, jnp.int32))
        tl, tst = tm.decode_step(tst, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
        jl = np.asarray(jl, np.float32)
        tl = tl.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
        else:
            assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max()
        pos = pos + 1


def _jax_tokens(jm, params):
    eng = JEngine(jm, params, max_batch=2, max_len=32)
    reqs = [JRequest(i, prompt=p, max_new=6) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [r.out for r in reqs]


def _port_tokens(engine):
    reqs = [Request(i, prompt=p, max_new=6) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_jax_float32(arch):
    jm, params, _, tm = _pair(arch, "float32", seed=1)
    want = _jax_tokens(jm, params)
    assert _port_tokens(ServeEngine(tm, max_batch=2, max_len=32)) == want


def test_cold_start_from_jax_image_gives_jax_tokens(tmp_path):
    jm, params, flat, _ = _pair("smollm-360m", "float32", seed=2)
    want = _jax_tokens(jm, params)
    blob, _ = create_image(flat, tenant="t", tenant_key=b"T" * 32,
                           store=JStore(tmp_path / "s"), root="r0",
                           chunk_size=4096)
    svc = ImageService(ChunkStore(tmp_path / "s"), ServiceConfig(device="cpu"))
    model = DecoderLM(get_config("smollm-360m").reduced(),
                      RunFlags(dtype="float32"), device="cpu")
    engine, stats = cold_start(model, blob, b"T" * 32, svc, max_batch=2,
                               max_len=32)
    assert stats["decode_backend"] == "torch-fused" and stats["streamed"]
    assert _port_tokens(engine) == want
    svc.close()


def test_state_to_tree_gives_back_the_jax_flat_tree():
    """The port's jax-free ``state_to_tree`` of the loaded parameters is
    the JAX ``state_to_tree`` of the JAX params: same paths, same bytes."""
    _, _, flat, tm = _pair("smollm-360m", "float32")
    got = port_state_to_tree(tm.params)
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


def test_load_flat_takes_exactly_the_jax_names_and_shapes():
    _, _, flat, tm = _pair("tinyllama-1.1b", "float32")
    with pytest.raises(KeyError):
        tm.load_flat({k: v for k, v in flat.items() if k != "unembed"})
    with pytest.raises(KeyError):
        tm.load_flat({**flat, "extra": np.zeros(1, np.float32)})
    bad = dict(flat)
    bad["embed"] = flat["embed"].reshape(-1, 2 * flat["embed"].shape[1])
    with pytest.raises(ValueError):
        tm.load_flat(bad)
