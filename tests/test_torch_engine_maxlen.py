"""A prompt longer than the engine's ``max_len`` (ROADMAP.md §3, fault
1, repaired): the JAX engine serves it, because its KV-cache scatter
drops the writes past the cache's last row; the port's
``update_kv_cache`` drops them too, so both engines give the same
greedy tokens. Reduced configs, the JAX ``init`` of
``jax.random.key(0)``, float32; tokens exactly equal."""
import pytest

torch = pytest.importorskip("torch")

from _torch_families import jax_params, port  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.lm import RunFlags as JFlags  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.models.attention import update_kv_cache  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

MAX_LEN = 8
PROMPTS = [list(range(1, 11)), [5, 6]]     # one past max_len, one in range
MAX_NEW = 3


def _serve(engine, request_cls, prompts):
    reqs = [request_cls(i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("arch", ["smollm-360m", "jamba-v0.1-52b",
                                  "xlstm-350m"])
def test_prompt_past_max_len_matches_jax(arch):
    flat, params = jax_params(arch)
    jm = jax_build(jax_config(arch).reduced(), JFlags(dtype="float32"))
    want = _serve(JEngine(jm, params, max_batch=2, max_len=MAX_LEN),
                  JRequest, PROMPTS)
    model = port(arch, flat, "float32")
    got = _serve(ServeEngine(model, max_batch=2, max_len=MAX_LEN),
                 Request, PROMPTS)
    assert got == want
    if not model.cfg.num_experts:
        # a dense model's in-range slot is untouched by its neighbour's
        # dropped writes (a MoE layer's expert capacity couples slots)
        alone = _serve(ServeEngine(model, max_batch=2, max_len=MAX_LEN),
                       Request, PROMPTS[1:])
        assert got[1] == alone[0]


def test_jax_tokens_of_the_long_prompt():
    """The reference's outputs for the long prompt, as ROADMAP.md §3
    records them."""
    want = {"smollm-360m": [210], "jamba-v0.1-52b": [169]}
    for arch, tokens in want.items():
        _, params = jax_params(arch)
        jm = jax_build(jax_config(arch).reduced(), JFlags(dtype="float32"))
        out = _serve(JEngine(jm, params, max_batch=2, max_len=MAX_LEN),
                     JRequest, PROMPTS[:1])
        assert out == [tokens]


def test_update_kv_cache_drops_rows_past_the_cache():
    """Lengths at and past Smax leave their sequence's cache as it was;
    the others write their row, bit for bit what indexing writes."""
    g = torch.Generator().manual_seed(0)
    B, Smax, H, hd = 4, 5, 2, 3
    k = torch.randn(B, Smax, H, hd, generator=g)
    v = torch.randn(B, Smax, H, hd, generator=g)
    k_new = torch.randn(B, H, hd, generator=g)
    v_new = torch.randn(B, H, hd, generator=g)
    lengths = torch.tensor([0, 4, 5, 9])
    want_k, want_v = k.clone(), v.clone()
    for b in (0, 1):
        want_k[b, lengths[b]] = k_new[b]
        want_v[b, lengths[b]] = v_new[b]
    update_kv_cache(k, v, k_new, v_new, lengths)
    assert torch.equal(k, want_k) and torch.equal(v, want_v)
