"""One rank of ``tests/test_torch_sharding_dist.py`` on the CPU (gloo):

    python tests/_torch_dist_worker.py WORLD RANK PORT OUT

World 8: ``compressed_psum`` over every rank, then on a (data 2, model
4) mesh the expert-parallel MoE (loss and every gradient) and the
sequence-parallel loss of a reduced arctic; world 4: two train steps of
a reduced tinyllama on a (2, 2) mesh. Inputs come from
``_torch_dist.inputs``; rank 0 saves the results to the npz file OUT.

    python tests/_torch_dist_worker.py 4 RANK PORT OUT opt8

runs the int8-moment cases of ``tests/test_torch_opt8_sharded.py`` on a
(2, 2) mesh instead (``opt8``; inputs from ``_torch_dist.opt8_inputs``)."""
import sys

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist import (
    OPT8_EXTRA,
    OPT8_VARIANTS,
    TRAIN_BATCH,
    TRAIN_SEQ,
    inputs,
    moe_config,
    nest,
    opt8_inputs,
    sp_config,
    train_config,
)


def _q8_leaves(opt: dict, prefix: str, res: dict, gather) -> None:
    """Every moment's q and scale (gathered) into `res` by name."""
    from repro_torch.train.optimizer import _is_q8
    for key in ("m", "v"):
        stack = [(key, opt[key])]
        while stack:
            name, node = stack.pop()
            if _is_q8(node):
                for part in ("q", "scale"):
                    res[f"{prefix}/{name}/{part}"] = gather(node[part])
            else:
                stack += [(f"{name}/{k}", v) for k, v in node.items()]


def opt8(rank: int, res: dict) -> None:
    """For each of OPT8_VARIANTS on a (2, 2) mesh: two ``adamw_update``
    calls on the model's and the extra leaves (int8 moments, no clip)
    against the same calls on plain tensors, then two train steps
    (``place_train_state``, ``make_train_step`` under the policy)
    against the plain steps."""
    import dataclasses

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import (
        place_batch,
        place_train_state,
        under_policy,
    )
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.variants import get_variant
    from repro_torch.models.lm import DecoderLM
    from repro_torch.sharding.constrain import FORCED, use_policy
    from repro_torch.sharding.rules import distribute_tree, specs_to_shardings
    from repro_torch.train.optimizer import (
        OptConfig,
        adamw_update,
        init_opt_state,
        opt_state_specs,
    )
    from repro_torch.train.step import make_train_step

    inp = opt8_inputs()
    mesh = make_local_mesh(2, 2, device_type="cpu")
    tr = train_config(get_config)
    shape = ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH, "train")

    def tensors(flat):
        return nest({k: torch.from_numpy(v.copy()) for k, v in flat.items()})

    def full(t):
        return t.full_tensor().numpy() if hasattr(t, "full_tensor") \
            else t.numpy()

    for variant in OPT8_VARIANTS:
        policy, flags, over = get_variant(variant, tr, SHAPES["train_4k"])
        # the variant's flags at this cell's size: a loss chunk that
        # divides its sequence
        flags = dataclasses.replace(flags, dtype="float32", chunked_loss=(
            TRAIN_SEQ // 2 if flags.chunked_loss else flags.chunked_loss))
        model = DecoderLM(tr, flags, device="cpu")
        specs = dict(model.param_specs())
        specs["x"] = {k: ax for k, (_, ax) in OPT8_EXTRA.items()}
        cfg = OptConfig(moments="int8", grad_clip=0.0)
        FORCED.clear()
        plain = tensors(inp["params"])
        pstate = init_opt_state(plain, cfg)
        with use_policy(mesh, policy), implicit_replication():
            dparams = distribute_tree(tensors(inp["params"]),
                                      specs_to_shardings(specs, plain, mesh,
                                                         policy))
            dstate = init_opt_state(plain, cfg)
            dstate = distribute_tree(dstate, specs_to_shardings(
                opt_state_specs(specs, cfg), dstate, mesh, policy))
            for s, g in enumerate(inp["grads"]):
                plain, pstate, _ = adamw_update(plain, tensors(g), pstate,
                                                cfg)
                dg = distribute_tree(tensors(g), specs_to_shardings(
                    specs, plain, mesh, policy))
                dparams, dstate, _ = adamw_update(dparams, dg, dstate, cfg)
                pre = f"{variant}/update{s}"
                _q8_leaves(pstate, f"{pre}/plain", res, full)
                _q8_leaves(dstate, f"{pre}/mesh", res, full)
                for name, t in zip(*_named(plain)):
                    res[f"{pre}/plain/param/{name}"] = t.numpy()
                for name, t in zip(*_named(dparams)):
                    res[f"{pre}/mesh/param/{name}"] = full(t)
        res[f"{variant}/update_forced"] = np.asarray(sorted(FORCED))
        res[f"{variant}/placements"] = np.asarray(
            [f"{n}: {t.placements}" for n, t in zip(*_named(dparams))])

        opt = OptConfig(**over)
        step = make_train_step(model, opt)
        own = {k: v for k, v in inp["params"].items()
               if not k.startswith("x/")}        # the model's leaves
        state = {"params": tensors(own)}
        state["opt"] = init_opt_state(state["params"], opt)
        losses = []
        for s, b in enumerate(inp["batches"]):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            losses.append(float(m["loss"]))
            _q8_leaves(state["opt"], f"{variant}/train{s}/plain", res, full)
        res[f"{variant}/train/plain_losses"] = np.asarray(losses)
        FORCED.clear()
        sstate = {"params": tensors(own)}
        sstate["opt"] = init_opt_state(sstate["params"], opt)
        sstate = place_train_state(model, sstate, mesh, policy, opt)
        sharded = under_policy(step, mesh, policy)
        losses = []
        for s, b in enumerate(inp["batches"]):
            batch = place_batch(model, {k: torch.from_numpy(v)
                                        for k, v in b.items()},
                                shape, mesh, policy)
            sstate, m = sharded(sstate, batch)
            losses.append(float(m["loss"].full_tensor()))
            _q8_leaves(sstate["opt"], f"{variant}/train{s}/mesh", res, full)
        res[f"{variant}/train/mesh_losses"] = np.asarray(losses)
        res[f"{variant}/train_forced"] = np.asarray(sorted(FORCED))


def _named(tree) -> tuple:
    from repro_torch.train.optimizer import _flatten, _paths
    return _paths(tree), _flatten(tree)


def main(world: int, rank: int, port: int, out: str, case: str = ""):
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.lm import DecoderLM, RunFlags
    from repro_torch.models.moe import moe_apply
    from repro_torch.sharding.collectives import compressed_psum
    from repro_torch.sharding.constrain import FORCED, use_policy
    from repro_torch.sharding.rules import (
        ShardingPolicy,
        distribute_tree,
        specs_to_shardings,
    )
    from repro_torch.train.optimizer import (
        OptConfig,
        init_opt_state,
        opt_state_specs,
    )
    from repro_torch.train.step import make_train_step

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    torch.manual_seed(0)
    inp = inputs() if case != "opt8" else None
    res = {}

    def place(model, flat, mesh, policy):
        tree = nest({k: torch.from_numpy(v) for k, v in flat.items()})
        return distribute_tree(tree, specs_to_shardings(
            model.param_specs(), tree, mesh, policy))

    def batch_of(model, arrays, mesh, policy, shape):
        tree = {k: torch.from_numpy(v) for k, v in arrays.items()}
        specs = {k: v for k, v in model.input_logical_specs(shape).items()
                 if k in tree}
        return distribute_tree(tree, specs_to_shardings(specs, tree, mesh,
                                                        policy))

    if case == "opt8":
        opt8(rank, res)
    elif world == 8:
        x = torch.from_numpy(inp["psum_x"][rank])
        res["psum"] = compressed_psum(x, dist.group.WORLD).numpy()
        from torch.distributed.device_mesh import init_device_mesh
        line = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        res["psum_mesh"] = compressed_psum(x, (line, "data")).numpy()

        mesh = make_local_mesh(2, 4, device_type="cpu")
        cfg = moe_config(get_config)
        rep = [Replicate(), Replicate()]
        p = {k: distribute_tensor(torch.from_numpy(v), mesh, rep)
             .requires_grad_() for k, v in inp["moe"].items()}
        xm = distribute_tensor(torch.from_numpy(inp["moe_x"]), mesh, rep)
        with use_policy(mesh, ShardingPolicy()), implicit_replication():
            y = moe_apply(nest(p), xm, cfg, torch.float32, impl="shard_map")
            loss = torch.sin(y).sum().full_tensor()
            grads = torch.autograd.grad(loss, list(p.values()))
        res["moe_loss"] = loss.detach().numpy()
        for k, g in zip(p, grads):
            res[f"moe_grad/{k}"] = g.full_tensor().numpy()

        from repro_torch.configs.base import ShapeConfig
        sp = sp_config(get_config)
        model = DecoderLM(sp, RunFlags(), device="cpu")
        pol = ShardingPolicy().with_rules("sp", seq=("model",))
        shape = ShapeConfig("sp", 32, 4, "train")
        FORCED.clear()
        with use_policy(mesh, pol), implicit_replication():
            params = place(model, inp["sp_params"], mesh, pol)
            batch = batch_of(model, {"tokens": inp["sp_tokens"],
                                     "labels": inp["sp_labels"]},
                             mesh, pol, shape)
            with torch.no_grad():
                res["sp_loss"] = model.loss(params, batch).full_tensor() \
                    .numpy()
        res["sp_forced"] = np.asarray(sorted(FORCED))
        with torch.no_grad():
            plain = nest({k: torch.from_numpy(v)
                          for k, v in inp["sp_params"].items()})
            res["sp_plain_loss"] = model.loss(plain, {
                "tokens": torch.from_numpy(inp["sp_tokens"]),
                "labels": torch.from_numpy(inp["sp_labels"])}).numpy()
    else:
        mesh = make_local_mesh(2, 2, device_type="cpu")
        tr = train_config(get_config)
        model = DecoderLM(tr, RunFlags(dtype="float32"), device="cpu")
        pol = ShardingPolicy()
        opt = OptConfig()
        from repro_torch.configs.base import ShapeConfig
        shape = ShapeConfig("t", 16, 4, "train")
        with use_policy(mesh, pol), implicit_replication():
            params = place(model, inp["train_params"], mesh, pol)
            plain = nest({k: torch.from_numpy(v)
                          for k, v in inp["train_params"].items()})
            opt_state = init_opt_state(plain, opt)
            ospecs = opt_state_specs(model.param_specs(), opt)
            opt_state = distribute_tree(opt_state, specs_to_shardings(
                ospecs, opt_state, mesh, pol))
            state = {"params": params, "opt": opt_state}
            step = make_train_step(model, opt)
            losses = []
            for b in inp["train_batches"]:
                state, metrics = step(state, batch_of(model, b, mesh, pol,
                                                      shape))
                losses.append(float(metrics["loss"].full_tensor()))
        res["train_losses"] = np.asarray(losses, np.float64)
        res["train_placements"] = np.asarray(
            str(state["params"]["g0"]["s0"]["mixer"]["wq"].placements))
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         *sys.argv[5:])
