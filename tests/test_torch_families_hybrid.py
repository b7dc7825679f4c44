"""The port's hybrid family (reduced jamba-v0.1-52b: one period of an
attention sublayer with a dense FFN and a Mamba sublayer with a MoE,
no positional embedding) against the JAX package's on the CPU, with the
same weights: ``load_flat``'s names, shapes and dtypes (``A_log`` stays
float32), ``prefill`` and ``decode_step`` logits in float32 and
bfloat16, the serving engine with reused slots, and prefill followed by
decoding against decoding alone (``tests/_torch_families.py`` holds the
shared checks and their tolerances)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_families as fam  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import DecoderLM, RunFlags, init_flat  # noqa: E402
from repro_torch.models.lm import layout  # noqa: E402

ARCH = "jamba-v0.1-52b"


def test_load_flat_takes_exactly_the_jax_names_and_shapes():
    fam.check_names_shapes_and_dtypes(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(dtype):
    fam.check_prefill_and_decode_logits(ARCH, dtype)


def test_engine_tokens_with_reused_slots_match_jax():
    fam.check_engine_with_reused_slots(ARCH)


def test_layout_of_one_jamba_period():
    subs = layout(get_config(ARCH))[0][1]
    assert [(s.mixer, s.ffn) for s in subs] == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe"), ("attn", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe")]
    assert all(s.d_ff == 14336 for s in subs if s.ffn == "dense")


@pytest.mark.parametrize("prompt", [2, 6])
def test_prefill_then_decode_equals_decoding(prompt):
    """With no assignment dropped (``capacity_factor`` = E / K, so the
    capacity is every token) prefilling a prompt and decoding from its
    state gives the logits of decoding every token, float32 states;
    a 2-token prompt is shorter than the conv window."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              capacity_factor=2.0)
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
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
