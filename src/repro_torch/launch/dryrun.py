"""Dry run of one (arch x shape x mesh) cell at full width (the port of
``repro.launch.dryrun``).

The JAX package forces 512 host devices and lowers the cell's jitted
step with shardings, then reads XLA's memory and cost analyses and the
HLO. The port builds the production mesh on ``torch.distributed``'s
fake process group (``init_fake_world``: one process plays every rank;
collectives return tensors of the right shape and move nothing) and
"lowers" by running the cell's train, prefill or decode step once on
``FakeTensorMode`` tensors (no memory is allocated), with the params,
optimizer state, decode state and inputs placed as DTensors by
``specs_to_shardings``. ``launch.roofline.StepCounter`` counts what
rank 0 runs: FLOPs, unfused bytes, collectives by kind, and the peak of
the storages the step allocates.

The record keeps the JAX package's keys, with these differences (each
also listed under ``"divergences"``):

* ``memory`` is rank 0's local shard bytes: ``argument_bytes`` (params,
  optimizer state, decode state, inputs), ``output_bytes`` (the step's
  results), ``temp_bytes`` (the peak of the storages allocated during
  the step, less the outputs allocated there) and ``alias_bytes`` (the
  results that are arguments updated in place);
* ``xla_cost_analysis`` holds the counted ``flops`` and
  ``bytes accessed`` (there is no XLA), ``hlo_bytes`` the number of
  operators counted, ``compile_s`` 0.0 (nothing is compiled);
* ``forced_replications`` counts the port's deliberate redistributions
  to ``Replicate()`` by site (``sharding.constrain.force_replicate``,
  and the int8 moments' ``opt8_*`` sites in ``train.optimizer``);
* ``moment_bytes`` (the port's own key) is rank 0's local bytes of the
  optimizer moments, m and v (``q`` and ``scale`` for int8), a part of
  ``argument_bytes``; 0 for a serving cell;
* ``device`` is the device type of the mesh and the fake tensors,
  ``--device`` (default "cuda", resolved by ``repro_torch.resolve_device``,
  so a machine without a card raises unless asked for "cpu"): on
  "cuda" the step takes the card's routes (``flash_attn``'s SDPA), on
  "cpu" the plain routes, and DTensor gathers and chunks where it would
  exchange all-to-all.

Without the fake backend the run fails; an operator that DTensor has
no sharding rule for raises. Records land in ``results/dryrun_torch/``
(or ``$REPRO_DRYRUN_DIR``).

Usage: PYTHONPATH=src python -m repro_torch.launch.dryrun --arch A
       --shape S [--multi-pod] [--variant V] [--no-save]
       [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.configs import SHAPES, applicable_shapes, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.modelflops import model_flops, param_counts
from repro_torch.launch.roofline import (
    _local_tensors,
    count_step,
    roofline_from_costs,
)
from repro_torch.launch.variants import VARIANTS, get_variant
from repro_torch.models.registry import build_model
from repro_torch.sharding.constrain import FORCED, use_policy
from repro_torch.sharding.rules import local_nbytes, specs_to_shardings
from repro_torch.train.optimizer import OptConfig, opt_state_specs
from repro_torch.train.step import (
    make_decode_step,
    make_prefill_step,
    make_train_step,
    train_state_template,
)

RESULTS_DIR = Path(os.environ.get(
    "REPRO_DRYRUN_DIR",
    Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"))

DIVERGENCES = {
    "memory": "rank 0's local shard bytes from the fake-tensor trace "
              "(arguments, outputs, peak of step allocations), not XLA's "
              "memory_analysis",
    "xla_cost_analysis": "the counted dot FLOPs and unfused bytes (no XLA)",
    "hlo_bytes": "operators counted on rank 0 (no HLO text)",
    "compile_s": "0.0: nothing is compiled",
    "roofline": "H100 SXM5 peaks; bytes are an unfused upper bound",
    "moment_bytes": "the port's own key: rank 0's local bytes of the "
                    "optimizer moments (m and v), part of argument_bytes",
}


def init_fake_world(world_size: int):
    """The default process group on the fake backend at `world_size`
    (one process, rank 0), made once; fails if the fake backend is
    missing or another group of a different size exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks exists; the dry run needs "
                               f"{world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def fake_dtensor(shape, dtype, sharding, device):
    """An uninitialised DTensor of global `shape` placed by the
    ``NamedSharding`` (call under a ``FakeTensorMode``; every sharded
    dim divides evenly, as ``logical_to_pspec`` makes them)."""
    from torch.distributed.tensor import DTensor, Shard

    mesh = sharding.mesh
    local = list(shape)
    for size, p in zip(tuple(mesh.shape), sharding.placements):
        if isinstance(p, Shard):
            local[p.dim] //= size
    return DTensor.from_local(torch.empty(local, dtype=dtype, device=device),
                              mesh, list(sharding.placements),
                              run_check=False)


def _place(spec_tree, tree, mesh, policy, device, dtype=None):
    """Fake DTensors of the shapes and dtypes (or `dtype`) of `tree`'s
    leaves, laid out by the logical specs."""
    from repro_torch.sharding.rules import NamedSharding, map2

    shards = specs_to_shardings(spec_tree, tree, mesh, policy)
    return map2(lambda sh, leaf: fake_dtensor(tuple(leaf.shape),
                                              dtype or leaf.dtype, sh,
                                              device),
                shards, tree, is_leaf=lambda x: isinstance(x, NamedSharding))


def under_policy(fn, mesh, policy):
    """`fn` run under (`mesh`, `policy`), plain tensors (positions,
    masks) taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*a):
        with use_policy(mesh, policy), implicit_replication():
            return fn(*a)
    return run


def build_step(model, shape, mesh, policy, opt_cfg: OptConfig,
               device: str):
    """(step, args) of `model`'s train, prefill or decode step for the
    ``ShapeConfig`` `shape` on fake DTensors of `device` placed on
    `mesh` by `policy` (call under a ``FakeTensorMode``)."""
    cfg = model.cfg
    template = train_state_template(cfg, opt_cfg)     # meta tensors
    pspecs = model.param_specs()
    batch = _place(model.input_logical_specs(shape),
                   model.input_specs(shape), mesh, policy, device)
    if shape.kind == "train":
        params = _place(pspecs, template["params"], mesh, policy, device)
        opt = _place(opt_state_specs(pspecs, opt_cfg), template["opt"],
                     mesh, policy, device)
        step = make_train_step(model, opt_cfg)
        return under_policy(step, mesh, policy), \
            ({"params": params, "opt": opt}, batch)
    params = _place(pspecs, template["params"], mesh, policy, device,
                    dtype=getattr(torch, model.flags.dtype))
    B, S = shape.global_batch, shape.seq_len
    kw = {"enc_len": S} if cfg.is_encdec else {}
    state_shapes = model.init_decode_state(B, S, torch.bfloat16, **kw)
    state = _place(model.decode_state_spec_tree(), state_shapes, mesh,
                   policy, device)
    if shape.kind == "prefill":
        return under_policy(make_prefill_step(model), mesh, policy), \
            (params, batch, state)
    return under_policy(make_decode_step(model), mesh, policy), \
        (params, state, batch["tokens"], batch["pos"])


def place_train_state(model, state: dict, mesh, policy,
                      opt_cfg: OptConfig) -> dict:
    """A real train state ({"params", "opt"} tensors) as DTensors laid
    out by the model's ``param_specs()`` and ``opt_state_specs``."""
    from repro_torch.sharding.rules import distribute_tree

    specs = {"params": model.param_specs(),
             "opt": opt_state_specs(model.param_specs(), opt_cfg)}
    return distribute_tree(state, specs_to_shardings(specs, state, mesh,
                                                     policy))


def place_batch(model, batch: dict, shape, mesh, policy) -> dict:
    """A real batch as DTensors laid out by ``input_logical_specs``
    (each made contiguous first, as a fresh device array is)."""
    from repro_torch.sharding.rules import distribute_tree

    specs = model.input_logical_specs(shape)
    batch = {k: v.contiguous() for k, v in batch.items()}
    return distribute_tree(batch, specs_to_shardings(
        {k: specs[k] for k in batch}, batch, mesh, policy))


def build_cell(arch: str, shape_name: str, mesh, variant: str = "baseline",
               device: str = "cuda"):
    """Set up one (arch x shape x mesh) cell on fake tensors of
    `device` (call under a ``FakeTensorMode``; a CUDA device needs a
    card). Returns (step, args, meta): ``step(*args)`` runs the cell's
    step under its policy."""
    device = resolve_device(device).type
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    policy, flags, opt_over = get_variant(variant, cfg, shape)
    model = build_model(cfg, flags, device=device)
    step, args = build_step(model, shape, mesh, policy,
                            OptConfig(**opt_over), device)
    return step, args, dict(cfg=cfg, shape=shape, model=model,
                            policy=policy)


def _alias_bytes(args, out) -> int:
    ins = {id(t.untyped_storage()) for t in _local_tensors(args)}
    seen, n = set(), 0
    for t in _local_tensors(out):
        key = id(t.untyped_storage())
        if key in ins and key not in seen:
            seen.add(key)
            n += t.untyped_storage().nbytes()
    return n


def trace(step, args) -> tuple:
    """(Costs, memory record) of one run of ``step(*args)`` counted by
    ``StepCounter``: rank 0's local argument, output, temporary and
    aliased bytes (module doc)."""
    out, costs = count_step(step, *args)
    arg_bytes = sum(local_nbytes(t) for t in _local_tensors(args))
    out_bytes = sum(local_nbytes(t) for t in _local_tensors(out))
    alias = _alias_bytes(args, out)
    temp = max(0, costs.peak_live_bytes - (out_bytes - alias))
    return costs, {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": temp, "alias_bytes": alias,
                   "per_device_total": arg_bytes + out_bytes + temp - alias}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             variant: str = "baseline", verbose: bool = True,
             device: str = "cuda") -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    device = resolve_device(device).type
    init_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    chips = mesh.size()
    FORCED.clear()
    with FakeTensorMode(allow_non_fake_inputs=True):
        t0 = time.time()
        step, args, meta = build_cell(arch, shape_name, mesh, variant,
                                      device)
        t_lower = time.time() - t0
        t0 = time.time()
        costs, memory = trace(step, args)
        t_count = time.time() - t0
    cfg, shape, model = meta["cfg"], meta["shape"], meta["model"]
    moments = [args[0]["opt"][k] for k in ("m", "v")] \
        if shape.kind == "train" else []
    moment_bytes = sum(local_nbytes(t) for t in _local_tensors(moments))
    mf = model_flops(cfg, shape, model.param_shapes())
    roof = roofline_from_costs(costs, chips, mf)
    counts = param_counts(cfg, model.param_shapes())

    rec = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "lower_s": round(t_lower + t_count, 2), "compile_s": 0.0,
        "param_count": counts["total_with_embed"],
        "param_active": counts["active"],
        "memory": memory,
        "moment_bytes": moment_bytes,
        "xla_cost_analysis": {"flops": costs.dot_flops,
                              "bytes accessed": costs.bytes_accessed},
        "roofline": roof.to_dict(),
        "hlo_bytes": costs.ops,
        "forced_replications": dict(FORCED),
        "device": device,
        "divergences": DIVERGENCES,
    }
    if verbose:
        m = rec["memory"]
        print(f"== {arch} x {shape_name} [{rec['mesh']}, {variant}] ==")
        print(f"  trace {rec['lower_s']:.1f}s  {costs.ops} ops on rank 0  "
              f"params {counts['total_with_embed']/1e9:.2f}B "
              f"(active {counts['active']/1e9:.2f}B)")
        print(f"  memory/rank: args {m['argument_bytes']/2**30:.2f} GiB  "
              f"temp {m['temp_bytes']/2**30:.2f} GiB  total "
              f"{m['per_device_total']/2**30:.2f} GiB")
        print(f"  moments/rank {moment_bytes/2**30:.2f} GiB  forced "
              f"replications: {rec['forced_replications']}")
        r = rec["roofline"]
        print(f"  roofline projection at H100 SXM5 datasheet peaks, "
              f"{chips} ranks: compute {r['compute_s']*1e3:.2f}ms  "
              f"memory {r['memory_s']*1e3:.2f}ms  "
              f"collective {r['collective_s']*1e3:.2f}ms  "
              f"-> {r['dominant']}-bound, MFU {r['mfu']*100:.1f}%, "
              f"useful {r['useful_fraction']*100:.1f}%")
        print(f"  collectives/rank: {r['collective_detail']}")
    return rec


def save_record(rec: dict):
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}_{rec['variant']}.json"
    (RESULTS_DIR / name).write_text(json.dumps(rec, indent=2))
    return RESULTS_DIR / name


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the mesh's and the fake tensors' device (cpu: "
                         "the plain routes)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    allowed = [s.name for s in applicable_shapes(cfg)]
    if args.shape not in allowed:
        print(f"SKIP: {args.arch} x {args.shape} not applicable "
              f"(full-attention arch at 500k)")
        return None
    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   variant=args.variant, device=args.device)
    if not args.no_save:
        path = save_record(rec)
        print(f"saved {path}")
    return rec


if __name__ == "__main__":
    main()
