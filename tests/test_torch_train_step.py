"""The port's training loss and gradients against the JAX package's, on
the CPU: ``DecoderLM.loss`` and ``torch.autograd.grad`` of it against
``jax.value_and_grad`` of the JAX ``DecoderLM.loss``, on the same
weights (the JAX ``init`` params of ``jax.random.key(0)`` through
``state_to_tree`` into a tree of float32 tensors that require grad) and
the same ``global_batch`` (which must equal the JAX one). Reduced
smollm in float32 and bfloat16 here; reduced arctic (MoE) and jamba
(hybrid) in ``tests/test_torch_train_step_families.py``.

Tolerances: float32 loss within 1e-5 (absolute, on a loss of ~5.5),
every float32 gradient within 1e-4 of its tensor's max |g|; bfloat16
loss within 1e-3 and gradients within 5e-2 of max |g| (both packages
round bfloat16 products, at different points: 1.8% measured for
smollm). The remat policies, ``chunked_loss`` and
``skip_masked_blocks`` compute the same function: their losses and
gradients are held to the ``remat="none"`` dense-logit run within
1e-6 of max |g|. ``aux_load_balance_loss`` within 1e-6 of the JAX
one."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_train import (  # noqa: E402
    assert_grads_close,
    check_against_jax,
    jax_loss_and_grads,
    port_loss_and_grads,
)
from repro.models.moe import aux_load_balance_loss as jax_aux  # noqa: E402
from repro_torch.models.attention import flash_attn  # noqa: E402
from repro_torch.models.lm import RunFlags  # noqa: E402
from repro_torch.models.moe import aux_load_balance_loss  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smollm_loss_and_grads_match_jax(dtype):
    check_against_jax("smollm-360m", dtype)


@pytest.mark.parametrize("flags", [
    dict(remat="full"), dict(remat="dots"), dict(chunked_loss=8),
    dict(remat="dots", chunked_loss=16), dict(skip_masked_blocks=True),
    dict(flash_vjp=True)])
def test_flags_compute_the_same_function(flags):
    flat, batch, _, _ = jax_loss_and_grads("smollm-360m", "float32")
    ref_loss, ref = port_loss_and_grads("smollm-360m", flat, batch,
                                        dtype="float32", remat="none")
    loss, grads = port_loss_and_grads("smollm-360m", flat, batch,
                                      dtype="float32", **flags)
    assert abs(loss - ref_loss) <= 1e-6
    assert_grads_close(grads, {k: g.numpy() for k, g in ref.items()}, 1e-6)


@pytest.mark.parametrize("seq,chunk", [(32, 12), (8, 16)])
def test_chunked_loss_refuses_a_ragged_sequence(seq, chunk):
    """Where S is not a multiple of the chunk the JAX reshape raises; the
    port raises too, never scoring part of the sequence."""
    from repro.models.common import chunked_softmax_xent as jax_xent
    from repro_torch.models.common import chunked_softmax_xent

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, seq, 4)).astype(np.float32)
    emb = rng.standard_normal((16, 4)).astype(np.float32)
    labels = rng.integers(0, 16, (2, seq)).astype(np.int32)
    with pytest.raises(TypeError):
        jax_xent(jnp.asarray(x), jnp.asarray(emb), jnp.asarray(labels), 16,
                 chunk)
    with pytest.raises(ValueError, match="multiple of the loss chunk"):
        chunked_softmax_xent(torch.from_numpy(x), torch.from_numpy(emb),
                             torch.from_numpy(labels), 16, chunk)


def test_moe_shard_map_raises_naming_item_6():
    """Item 6 is ported: ``moe_impl="shard_map"`` builds, and with no
    sharding policy active it takes the sort route, as the JAX
    package's does (the same output, bit for bit); an unknown
    ``moe_impl`` or ``remat`` still raises."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.lm import init_flat
    from repro_torch.train.step import nest

    assert RunFlags(moe_impl="shard_map").moe_impl == "shard_map"
    cfg = get_config("kimi-k2-1t-a32b").reduced()

    def layer0(t):
        if isinstance(t, dict):
            return {k: layer0(v) for k, v in t.items()}
        return torch.from_numpy(t[0])
    p = layer0(nest(init_flat(cfg, 0))["g1"]["s0"]["ffn"])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    assert torch.equal(moe_apply(p, x, cfg, torch.float32, impl="shard_map"),
                       moe_apply(p, x, cfg, torch.float32, impl="sort"))
    with pytest.raises(ValueError):
        RunFlags(moe_impl="gather")
    with pytest.raises(ValueError):
        RunFlags(remat="some")


def test_skip_masked_blocks_covers_every_row():
    """Skipping dead key blocks keeps every key a query row sees, also
    where a query block crosses a key-block boundary (q_block 3,
    kv_block 5), and the gradients are the unskipped ones."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.standard_normal((1, 15, 2, 8)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    outs = []
    for skip in (False, True):
        o = flash_attn(q, k, v, q_block=3, kv_block=5,
                       skip_masked_blocks=skip)
        outs.append((o, torch.autograd.grad(o.square().sum(), (q, k, v))))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_aux_load_balance_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    experts = np.argsort(-logits, axis=-1)[:, :2].astype(np.int32)
    want = float(jax_aux(jnp.asarray(logits), jnp.asarray(experts), 8, 2))
    got = aux_load_balance_loss(torch.from_numpy(logits),
                                torch.from_numpy(experts), 8, 2)
    assert abs(got.item() - want) <= 1e-6
