"""Named (ShardingPolicy, RunFlags, OptConfig-overrides) bundles (the
port of ``repro.launch.variants``: the same names and contents).

``baseline`` is the paper-faithful starting point; the others are the
JAX package's §Perf hillclimb variants. The policy applies under
``sharding.constrain.use_policy`` on a mesh (``launch.dryrun``, a
multi-rank run); on one device without a mesh only the flags and the
optimizer overrides change anything.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.lm import RunFlags
from repro_torch.sharding.rules import ShardingPolicy

VARIANTS: dict[str, dict] = {
    # Megatron-TP on `model` + ZeRO-1/3-style FSDP on `data`, pure DP on
    # `pod`; full per-layer remat; dense final logits.
    "baseline": {},

    # §Perf: causally-dead flash blocks skipped (triangular schedule).
    "causal_skip": {"flags": dict(skip_masked_blocks=True)},

    # §Perf: seq-chunked xent avoids the (B,S,V) logits buffer.
    "chunked_loss": {"flags": dict(chunked_loss=512)},

    # §Perf: cheaper remat policy — keep matmul outputs, recompute the rest.
    "remat_dots": {"flags": dict(remat="dots")},

    # §Perf: FSDP over (pod, data) — params sharded across pods too
    # (halves per-chip weight bytes on the 512-chip mesh).
    "fsdp_pods": {"policy": dict(fsdp=("pod", "data"))},

    # §Perf: 8-bit Adam moments (fits kimi-k2 on the assigned meshes).
    "opt8bit": {"opt": dict(moments="int8")},

    # §Perf: sequence-sharded KV cache for long-context decode.
    "kv_seq_shard": {"policy": dict(kv_seq=("model",))},

    # §Perf: custom-VJP flash attention — backward recomputes score blocks
    # instead of storing them (kills the O(S^2) residual HBM traffic).
    "flash_vjp": {"flags": dict(flash_vjp=True)},

    # §Perf: explicit EP all-to-all MoE dispatch via shard_map.
    "moe_a2a": {"flags": dict(moe_impl="shard_map")},

    # §Perf (serving): weights TP-sharded only, replicated across data —
    # no per-token FSDP all-gather on the decode path.
    "serve_replicated": {"policy": dict(fsdp=())},

    # §Perf: pure ZeRO-3 data parallelism — no tensor parallelism, so no
    # per-layer activation all-reduces (which XLA keeps in f32); weights
    # all-gathered per layer instead. Hypothesis: wins when
    # tokens-per-chip x d_model x 6 > 3 x layer_params.
    "zero3": {"policy": dict(batch=("pod", "data", "model"),
                             fsdp=("data", "model"),
                             tp=(), heads=(), kv_heads=(), vocab=(),
                             tp_inner=("data",))},

    # zero3 + the attention/loss levers
    "zero3_tuned": {"policy": dict(batch=("pod", "data", "model"),
                                   fsdp=("data", "model"),
                                   tp=(), heads=(), kv_heads=(), vocab=(),
                                   tp_inner=("data",)),
                    "flags": dict(flash_vjp=True, chunked_loss=512,
                                  moe_impl="shard_map")},

    # multi-pod zero3: global batch (256) < devices (512), so batch shards
    # over (pod,data) and SEQUENCE shards over model (SP attention engages
    # via the seq rule); weights/moments still ZeRO-3 over all 512.
    "zero3_mp": {"policy": dict(batch=("pod", "data"), seq=("model",),
                                fsdp=("pod", "data", "model"),
                                tp=(), heads=(), kv_heads=(), vocab=(),
                                tp_inner=("data",)),
                 "flags": dict(flash_vjp=True, chunked_loss=512,
                               moe_impl="shard_map"),
                 "opt": dict(moments="bfloat16")},

    # zero3_tuned + bf16 Adam moments: halves optimizer memory with zero
    # layout mismatch (moments keep param sharding)
    "zero3_tuned_bf16m": {"policy": dict(batch=("pod", "data", "model"),
                                         fsdp=("data", "model"),
                                         tp=(), heads=(), kv_heads=(),
                                         vocab=(), tp_inner=("data",)),
                          "flags": dict(flash_vjp=True, chunked_loss=512,
                                        moe_impl="shard_map"),
                          "opt": dict(moments="bfloat16")},

    # zero3_tuned + int8 Adam moments: the kimi-k2 memory-fit variant
    "zero3_tuned8": {"policy": dict(batch=("pod", "data", "model"),
                                    fsdp=("data", "model"),
                                    tp=(), heads=(), kv_heads=(), vocab=(),
                                    tp_inner=("data",)),
                     "flags": dict(flash_vjp=True, chunked_loss=512,
                                   moe_impl="shard_map"),
                     "opt": dict(moments="int8")},

    # serving: TP weights replicated over data + EP all-to-all MoE
    "serve_tuned": {"policy": dict(fsdp=()),
                    "flags": dict(moe_impl="shard_map")},

    # sequence-parallel attention + EP all-to-all MoE: for archs whose
    # head count doesn't divide the model axis (arctic: 56 heads / 16)
    "sp_moe": {"policy": dict(seq=("model",)),
               "flags": dict(moe_impl="shard_map")},

    # combined best-known variants (outcome of the §Perf hillclimb)
    "tuned_train": {"flags": dict(flash_vjp=True, moe_impl="shard_map",
                                  chunked_loss=512, remat="dots")},
    "tuned_train_fullremat": {"flags": dict(flash_vjp=True,
                                            moe_impl="shard_map",
                                            chunked_loss=512)},
    "tuned_decode": {"policy": dict(fsdp=(), kv_seq=("model",))},
}


def get_variant(name: str, cfg: ModelConfig, shape: ShapeConfig):
    """(ShardingPolicy, RunFlags, OptConfig overrides) of a variant;
    `cfg` and `shape` are accepted as in the JAX package (its policy
    does not read them either)."""
    spec = VARIANTS[name]
    policy = ShardingPolicy(name=name)
    if "policy" in spec:
        policy = policy.with_rules(name, **spec["policy"])
    flags = RunFlags(**spec.get("flags", {}))
    opt = spec.get("opt", {})
    return policy, flags, opt
