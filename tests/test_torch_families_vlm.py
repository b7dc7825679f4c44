"""The port's VLM family (reduced pixtral-12b: a dense backbone whose
sequences start with 8 precomputed patch embeddings, RoPE theta 1e6)
against the JAX package's on the CPU, with the same weights:
``load_flat``'s names and shapes, the training loss and every gradient
against ``jax.value_and_grad`` (patch rows dropped before the logits;
``tests/_torch_train.py``'s tolerances), ``prefill`` over patches and
tokens then ``decode_step`` from position P + T in float32 and bfloat16,
the serving engine (tokens only, as in the JAX package), and
``prefill(patches + T tokens)`` against ``prefill(patches + T - 8)``
followed by 8 decode steps. Also ``global_batch`` for the ``vlm`` and
encoder-decoder families, bitwise the JAX package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_families as fam  # noqa: E402
from _torch_train import check_against_jax  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.synthetic import global_batch as jax_batch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import global_batch  # noqa: E402
from repro_torch.models import DecoderLM, RunFlags, init_flat  # noqa: E402

ARCH = "pixtral-12b"


def test_load_flat_takes_exactly_the_jax_names_and_shapes():
    fam.check_names_shapes_and_dtypes(ARCH)


def test_loss_and_grads_match_jax():
    check_against_jax(ARCH, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(dtype):
    fam.check_prefill_and_decode_logits(ARCH, dtype)


def test_engine_tokens_with_reused_slots_match_jax():
    fam.check_engine_with_reused_slots(ARCH)


@pytest.mark.parametrize("arch", ["pixtral-12b", "whisper-base"])
def test_global_batch_matches_jax(arch):
    for reduced in (True, False):
        cfg, jcfg = get_config(arch), jax_config(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        for step in (0, 7):
            got = global_batch(cfg, step, 2, 300, seed=5)
            want = jax_batch(jcfg, step, 2, 300, seed=5)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_prefill_then_decode_equals_longer_prefill():
    """Patches + 12 tokens prefilled at once give the greedy tokens and
    logits of patches + 4 tokens prefilled, then 8 decode steps from
    position P + 4 (float32 states)."""
    cfg = get_config(ARCH).reduced()
    m = DecoderLM(cfg, RunFlags(dtype="float32"),
                  device="cpu").load_flat(init_flat(cfg, 5))
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 12)))
    patches = torch.from_numpy(rng.standard_normal(
        (2, cfg.num_patches, cfg.d_model), np.float32) * 0.02)
    want, _ = m.prefill({"tokens": toks, "patches": patches},
                        m.init_decode_state(2, 32, torch.float32))
    st = m.init_decode_state(2, 32, torch.float32)
    _, st = m.prefill({"tokens": toks[:, :4], "patches": patches}, st)
    P = cfg.num_patches
    for t in range(4, 12):
        got, st = m.decode_step(st, toks[:, t], torch.full((2,), P + t))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
