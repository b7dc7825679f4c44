"""The port's training loss and gradients against the JAX package's for
the MoE (reduced arctic: top-2 of 4 experts beside a dense residual MLP)
and hybrid (reduced jamba: attention and Mamba sublayers, MoE on odd
slots) families, in float32, on the CPU; the checks and tolerances of
``tests/test_torch_train_step.py`` (loss within 1e-5, every gradient
within 1e-4 of its tensor's max |g|). A JAX model init and its jitted
``value_and_grad`` cost a few seconds per config, hence a file of their
own."""
import pytest

pytest.importorskip("torch")

from _torch_train import check_against_jax  # noqa: E402


@pytest.mark.parametrize("arch", ["arctic-480b", "jamba-v0.1-52b"])
def test_family_loss_and_grads_match_jax(arch):
    check_against_jax(arch, "float32")
