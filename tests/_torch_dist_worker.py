"""One rank of ``tests/test_torch_sharding_dist.py`` on the CPU (gloo):

    python tests/_torch_dist_worker.py WORLD RANK PORT OUT

World 8: ``compressed_psum`` over every rank, then on a (data 2, model
4) mesh the expert-parallel MoE (loss and every gradient) and the
sequence-parallel loss of a reduced arctic; world 4: two train steps of
a reduced tinyllama on a (2, 2) mesh. Inputs come from
``_torch_dist.inputs``; rank 0 saves the results to the npz file OUT."""
import sys

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist import (
    inputs,
    moe_config,
    nest,
    sp_config,
    train_config,
)


def main(world: int, rank: int, port: int, out: str):
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
    inp = inputs()
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

    if world == 8:
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
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
