"""The port's MoE family, reduced kimi-k2-1t-a32b (a dense first layer
of d_ff ``dense_d_ff``, then MoE layers of 384 experts top-8 cut to 4
top-2 with a shared expert), against the JAX package's on the CPU, with
the same weights: ``load_flat``'s names, shapes and dtypes, ``prefill``
and ``decode_step`` logits in float32 and bfloat16, and the serving
engine with reused slots (``tests/_torch_families.py`` holds the checks
and their tolerances)."""
import pytest

torch = pytest.importorskip("torch")

import _torch_families as fam  # noqa: E402

ARCH = "kimi-k2-1t-a32b"


def test_load_flat_takes_exactly_the_jax_names_and_shapes():
    fam.check_names_shapes_and_dtypes(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(dtype):
    fam.check_prefill_and_decode_logits(ARCH, dtype)


def test_engine_tokens_with_reused_slots_match_jax():
    fam.check_engine_with_reused_slots(ARCH)
