"""Shared checks of the port's training path against the JAX package on
the CPU (``tests/test_torch_train_step*.py``): the JAX ``init`` params
of ``jax.random.key(0)`` through ``state_to_tree`` into a tree of
float32 tensors that require grad, the same ``global_batch``, and
``jax.value_and_grad`` of the JAX ``DecoderLM.loss`` against
``torch.autograd.grad`` of the port's. Tolerances (``TOL``): float32
loss within 1e-5, gradients within 1e-4 of each tensor's max |g|;
bfloat16 loss within 1e-3, gradients within 5e-2 of max |g|."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.data.synthetic import global_batch as jax_batch
from repro.models import build_model as jax_build
from repro.models.lm import RunFlags as JFlags
from repro.train.checkpoint import state_to_tree
from repro_torch.configs import get_config
from repro_torch.data.synthetic import global_batch
from repro_torch.models import RunFlags, build_model
from repro_torch.train.step import nest

TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 5e-2)}


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch: str, dtype: str, step: int = 3) -> tuple:
    """(flat params, batch, loss, flat grads) of the JAX package."""
    jcfg = jax_config(arch).reduced()
    jm = jax_build(jcfg, JFlags(dtype=dtype))
    params = jax.jit(jm.init)(jax.random.key(0))
    batch = jax_batch(jcfg, step, 2, 32, seed=0)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return state_to_tree(params), batch, float(loss), state_to_tree(grads)


def port_loss_and_grads(arch: str, flat: dict, batch: dict,
                        **flags) -> tuple:
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in flat.items()}
    model = build_model(get_config(arch).reduced(), RunFlags(**flags),
                        device="cpu")
    loss = model.loss(nest(leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), {k: g for k, g in zip(leaves, grads)}


def assert_grads_close(got: dict, want: dict, rel: float):
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert g.dtype == torch.float32, name
        w = np.asarray(want[name], np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= rel * scale, (name, err, scale)


def assert_zero_grads(got: dict, want: dict, names: list, rel: float):
    """The leaves `names`, whose gradient is zero in exact arithmetic,
    within `rel` of the largest gradient of any leaf in both packages
    (their own max is rounding noise, no scale to compare against)."""
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name in names:
        assert float(got[name].abs().max()) <= rel * scale, name
        assert float(np.abs(np.asarray(want[name])).max()) <= rel * scale, \
            name


def check_against_jax(arch: str, dtype: str, zero_grads: tuple = ()):
    """Loss and gradients within ``TOL``; the leaves whose names end with
    one of `zero_grads` (gradients zero in exact arithmetic, e.g. an
    attention key bias: softmax ignores a constant added to a row of
    scores) within 1e-6 of the largest gradient instead."""
    flat, batch, want_loss, want_grads = jax_loss_and_grads(arch, dtype)
    port_batch = global_batch(get_config(arch).reduced(), 3, 2, 32, seed=0)
    for k in batch:
        np.testing.assert_array_equal(port_batch[k], batch[k])
    loss, grads = port_loss_and_grads(arch, flat, port_batch, dtype=dtype)
    loss_tol, grad_tol = TOL[dtype]
    assert abs(loss - want_loss) <= loss_tol
    assert grads.keys() == want_grads.keys()
    zero = [n for n in grads if n.endswith(zero_grads)] if zero_grads else []
    assert_zero_grads(grads, want_grads, zero, 1e-6)
    assert_grads_close({k: g for k, g in grads.items() if k not in zero},
                       {k: w for k, w in want_grads.items() if k not in zero},
                       grad_tol)
