"""Shared inputs and the JAX side of ``tests/test_torch_sharding_dist.py``
and ``tests/test_torch_opt8_sharded.py``.

``python tests/_torch_dist.py OUT`` runs the JAX package's multi-device
functions on 8 host devices (``AxisType.Auto`` meshes: jax.make_mesh's
default Explicit axes refuse the reference's ``shard_map`` calls on jax
0.9) and saves their results to the npz file OUT. The port's ranks
(``tests/_torch_dist_worker.py``) build the same inputs from the same
numpy seeds with ``inputs``. ``python tests/_torch_dist.py OUT opt8``
runs the JAX package's int8 update over ``opt8_inputs`` (``jax_opt8``).
"""
import os
import sys

import numpy as np

B_MOE, S_MOE = 4, 8
SP_BATCH, SP_SEQ = 4, 32
TRAIN_BATCH, TRAIN_SEQ = 4, 16


def moe_config(get_config):
    return get_config("kimi-k2-1t-a32b").reduced(
        num_experts=8, experts_per_token=2, d_model=32, d_ff=64,
        capacity_factor=8.0, shared_experts=1, first_dense_layers=0)


def sp_config(get_config):
    return get_config("arctic-480b").reduced(
        num_heads=6, num_kv_heads=2, head_dim=16, d_model=96, d_ff=128,
        dense_d_ff=128)


def train_config(get_config):
    return get_config("tinyllama-1.1b").reduced(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256)


def inputs() -> dict:
    """Every input, as numpy, from fixed seeds (the port's ``init_flat``
    draws the models' weights)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_flat

    rng = np.random.default_rng(0)
    out = {"psum_x": rng.standard_normal((8, 1024)).astype(np.float32)}
    cfg = moe_config(get_config)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    moe = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
           "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
           "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
           "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F),
           "shared/w_gate": rng.standard_normal((D, F)) / np.sqrt(D),
           "shared/w_up": rng.standard_normal((D, F)) / np.sqrt(D),
           "shared/w_down": rng.standard_normal((F, D)) / np.sqrt(F)}
    out["moe"] = {k: v.astype(np.float32) for k, v in moe.items()}
    out["moe_x"] = rng.standard_normal((B_MOE, S_MOE, D)).astype(np.float32)
    sp = sp_config(get_config)
    out["sp_params"] = init_flat(sp, 1)
    out["sp_tokens"] = rng.integers(0, sp.vocab_size, (SP_BATCH, SP_SEQ),
                                    dtype=np.int32)
    out["sp_labels"] = rng.integers(0, sp.vocab_size, (SP_BATCH, SP_SEQ),
                                    dtype=np.int32)
    tr = train_config(get_config)
    out["train_params"] = init_flat(tr, 2)
    out["train_batches"] = [
        {k: rng.integers(0, tr.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                         dtype=np.int32) for k in ("tokens", "labels")}
        for _ in range(2)]
    return out


# int8 moments on a (2, 2) mesh (tests/test_torch_opt8_sharded.py): the
# two variants' rules, and leaves beside the model's that take the
# route's other cases: sharded on non-leading dims with data spanning
# row ranks and a partial last block (odd, expert), replicated (vec), no
# dim that the row group divides (tiny)
OPT8_VARIANTS = ("opt8bit", "zero3_tuned8")
OPT8_EXTRA = {"odd": ((3, 200, 132), (None, "tp", "fsdp")),
              "expert": ((4, 8, 96, 40), (None, "expert", "fsdp",
                                          "tp_inner")),
              "vec": ((1000,), (None,)),
              "tiny": ((3, 5, 7), (None, None, None))}


def opt8_inputs() -> dict:
    """The int8 cases' inputs from fixed seeds: the reduced tinyllama's
    params (``init_flat``) and the extra leaves (under "x/"), seeded
    gradients for two updates, two train batches."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_flat

    rng = np.random.default_rng(24)
    tr = train_config(get_config)
    params = dict(init_flat(tr, 3))
    for name, (shape, _) in OPT8_EXTRA.items():
        params[f"x/{name}"] = rng.standard_normal(shape).astype(np.float32)
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** -s)
              .astype(np.float32) for k, v in params.items()}
             for s in range(2)]
    batches = [{k: rng.integers(0, tr.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                                dtype=np.int32) for k in ("tokens", "labels")}
               for _ in range(2)]
    return {"params": params, "grads": grads, "batches": batches}


def nest(flat: dict) -> dict:
    out: dict = {}
    for name, leaf in flat.items():
        *head, last = name.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def jax_reference(path: str):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.models import build_model
    from repro.models.lm import RunFlags
    from repro.models.moe import moe_apply
    from repro.sharding.collectives import compressed_psum
    from repro.sharding.constrain import use_policy
    from repro.sharding.rules import ShardingPolicy
    from repro.train.optimizer import OptConfig, init_opt_state
    from repro.train.step import make_train_step

    def mesh(shape, names):
        return jax.make_mesh(shape, names,
                             axis_types=(AxisType.Auto,) * len(shape))

    inp = inputs()
    res = {}
    m8 = mesh((8,), ("data",))
    f = shard_map(lambda xs: compressed_psum(xs[0], "data"), mesh=m8,
                  in_specs=P("data", None), out_specs=P())
    res["psum"] = np.asarray(f(jnp.asarray(inp["psum_x"])))
    res["psum_exact"] = inp["psum_x"].mean(axis=0)

    cfg = moe_config(get_config)
    p = jax.tree.map(jnp.asarray, nest(inp["moe"]))
    x = jnp.asarray(inp["moe_x"])
    m24 = mesh((2, 4), ("data", "model"))
    with use_policy(m24, ShardingPolicy()):
        for impl in ("sort", "shard_map"):
            fn = jax.jit(lambda p, impl=impl: jnp.sum(jnp.sin(
                moe_apply(p, x, cfg, jnp.float32, impl=impl))))
            loss, g = jax.value_and_grad(fn)(p)
            res[f"moe_{impl}_loss"] = np.float32(loss)
            for k, v in jax.tree_util.tree_flatten_with_path(g)[0]:
                name = "/".join(str(getattr(e, "key", e)) for e in k)
                res[f"moe_{impl}_grad/{name}"] = np.asarray(v)

    sp = sp_config(get_config)
    model = build_model(sp)
    params = jax.tree.map(jnp.asarray, nest(inp["sp_params"]))
    batch = {"tokens": jnp.asarray(inp["sp_tokens"]),
             "labels": jnp.asarray(inp["sp_labels"])}
    res["sp_plain_loss"] = np.float32(model.loss(params, batch))
    pol = ShardingPolicy().with_rules("sp", seq=("model",))
    try:
        with use_policy(m24, pol):
            res["sp_loss"] = np.float32(jax.jit(model.loss)(params, batch))
    except Exception as e:  # the reference's SP route on this jax
        print(f"SP route failed: {type(e).__name__}: {e}", file=sys.stderr)

    tr = train_config(get_config)
    model = build_model(tr, RunFlags(dtype="float32"))
    opt = OptConfig()
    params = jax.tree.map(jnp.asarray, nest(inp["train_params"]))
    state = {"params": params, "opt": init_opt_state(params, opt)}
    step = jax.jit(make_train_step(model, opt))
    losses = []
    for b in inp["train_batches"]:
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    res["train_losses"] = np.asarray(losses, np.float64)
    np.savez(path, **res)


def jax_opt8(path: str):
    """The JAX package's int8 ``adamw_update`` (no clip) over
    ``opt8_inputs``: each moment's q and scale after each update, saved
    under the worker's names ("update{s}/m/<leaf>/q")."""
    import jax
    import jax.numpy as jnp

    from repro.train.optimizer import OptConfig, adamw_update, init_opt_state

    inp = opt8_inputs()
    cfg = OptConfig(moments="int8", grad_clip=0.0)
    params = jax.tree.map(jnp.asarray, nest(inp["params"]))
    state = init_opt_state(params, cfg)
    res = {}
    for s, g in enumerate(inp["grads"]):
        params, state, _ = adamw_update(
            params, jax.tree.map(jnp.asarray, nest(g)), state, cfg)
        for key in ("m", "v"):
            flat = jax.tree_util.tree_flatten_with_path(state[key])[0]
            for path_, leaf in flat:
                name = "/".join(str(getattr(e, "key", e)) for e in path_)
                res[f"update{s}/{key}/{name}"] = np.asarray(leaf)
    np.savez(path, **res)


if __name__ == "__main__":
    if sys.argv[2:] == ["opt8"]:
        jax_opt8(sys.argv[1])
    else:
        jax_reference(sys.argv[1])
