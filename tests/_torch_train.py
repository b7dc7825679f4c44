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
from repro_torch.models.lm import DecoderLM, RunFlags
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
    model = DecoderLM(get_config(arch).reduced(), RunFlags(**flags),
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


def check_against_jax(arch: str, dtype: str):
    flat, batch, want_loss, want_grads = jax_loss_and_grads(arch, dtype)
    port_batch = global_batch(get_config(arch).reduced(), 3, 2, 32, seed=0)
    for k in batch:
        np.testing.assert_array_equal(port_batch[k], batch[k])
    loss, grads = port_loss_and_grads(arch, flat, port_batch, dtype=dtype)
    loss_tol, grad_tol = TOL[dtype]
    assert abs(loss - want_loss) <= loss_tol
    assert_grads_close(grads, want_grads, grad_tol)
