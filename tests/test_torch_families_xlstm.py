"""The port's xLSTM family (reduced xlstm-350m: one pair of an mLSTM and
an sLSTM sublayer, layernorm, no positional embedding, no FFN beside
the sLSTM's own) against the JAX package's on the CPU, with the same
weights: ``load_flat``'s names, shapes and dtypes (``b_if``, ``r`` and
``b`` stay float32), the training loss and every gradient against
``jax.value_and_grad`` (``tests/_torch_train.py``: loss within 1e-5,
gradients within 1e-4 of each tensor's max |g|), ``prefill`` and
``decode_step`` logits in float32 and bfloat16, the serving engine with
reused slots (``tests/_torch_families.py``), and prefill followed by
decoding against decoding alone."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_families as fam  # noqa: E402
from _torch_train import check_against_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import DecoderLM, RunFlags, init_flat  # noqa: E402
from repro_torch.models.lm import layout  # noqa: E402

ARCH = "xlstm-350m"


def test_load_flat_takes_exactly_the_jax_names_and_shapes():
    fam.check_names_shapes_and_dtypes(ARCH, victim="mixer/ff_up")


def test_loss_and_grads_match_jax():
    check_against_jax(ARCH, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(dtype):
    fam.check_prefill_and_decode_logits(ARCH, dtype)


def test_engine_tokens_with_reused_slots_match_jax():
    fam.check_engine_with_reused_slots(ARCH)


def test_layout_of_xlstm_pairs():
    (R, subs), = layout(get_config(ARCH))
    assert R == 12
    assert [(s.mixer, s.ffn) for s in subs] == [("mlstm", "none"),
                                                ("slstm", "none")]


@pytest.mark.parametrize("prompt", [2, 6])
def test_prefill_then_decode_equals_decoding(prompt):
    """Prefilling a prompt and decoding from its state gives the logits
    and cell states of decoding every token, float32 states; a 2-token
    prompt is shorter than the sLSTM conv window."""
    cfg = get_config(ARCH).reduced()
    m = DecoderLM(cfg, RunFlags(dtype="float32"),
                  device="cpu").load_flat(init_flat(cfg, 5))
    toks = np.random.default_rng(prompt).integers(0, 256, (3, prompt + 2))
    st = m.init_decode_state(3, 16, torch.float32)
    _, st = m.prefill({"tokens": torch.from_numpy(toks[:, :prompt])}, st)
    ref = m.init_decode_state(3, 16, torch.float32)
    for t in range(prompt + 2):
        want, ref = m.decode_step(ref, torch.from_numpy(toks[:, t]),
                                  torch.full((3,), t))
        if t >= prompt:
            got, st = m.decode_step(st, torch.from_numpy(toks[:, t]),
                                    torch.full((3,), t))
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    for j in ("s0", "s1"):
        for k, v in ref["g0"][j].items():
            torch.testing.assert_close(st["g0"][j][k], v, atol=1e-5, rtol=0)
