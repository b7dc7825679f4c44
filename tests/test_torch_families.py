"""The port's MoE family, reduced arctic-480b (128 experts top-2 cut to
4, with its dense residual MLP), against the JAX package's on the CPU,
with the same weights: ``load_flat``'s names, shapes and dtypes,
``prefill`` and ``decode_step`` logits in float32 and bfloat16, and the
serving engine with reused slots (``tests/_torch_families.py`` holds
the checks and their tolerances). Also the MoE layouts at full width,
``build_model``'s families and the init rules of ``init_flat`` and
``init_device``. Kimi is in ``tests/test_torch_families_kimi.py``, the
hybrid family in ``tests/test_torch_families_hybrid.py`` and
``expert_shard_restore`` in ``tests/test_torch_expert_shard.py``: one
file each keeps each file's JAX compiles to seconds."""
import pytest

torch = pytest.importorskip("torch")

import _torch_families as fam  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import DecoderLM, build_model  # noqa: E402
from repro_torch.models.lm import F32_LEAVES, flat_specs, init_device, \
    init_flat, param_specs  # noqa: E402

ARCH = "arctic-480b"


def test_load_flat_takes_exactly_the_jax_names_and_shapes():
    fam.check_names_shapes_and_dtypes(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(dtype):
    fam.check_prefill_and_decode_logits(ARCH, dtype)


def test_engine_tokens_with_reused_slots_match_jax():
    fam.check_engine_with_reused_slots(ARCH)


def test_layouts_of_the_moe_family():
    """Kimi: a dense first layer of d_ff ``dense_d_ff`` (g0), then the
    MoE layers (g1) with a shared expert; arctic: one MoE group with a
    dense residual MLP."""
    kimi = flat_specs(param_specs(get_config("kimi-k2-1t-a32b")))
    assert kimi["g0/s0/ffn/w_up"].shape == (1, 7168, 18432)
    assert kimi["g1/s0/ffn/w_up"].shape == (60, 384, 7168, 2048)
    assert kimi["g1/s0/ffn/shared/w_up"].shape == (60, 7168, 2048)
    assert kimi["g1/s0/ffn/router"].shape == (60, 7168, 384)
    arctic = flat_specs(param_specs(get_config("arctic-480b")))
    assert arctic["g0/s0/ffn/w_down"].shape == (35, 128, 4864, 7168)
    assert arctic["g0/s0/ffn/residual/w_down"].shape == (35, 4864, 7168)
    assert not any(k.startswith("g1/") for k in arctic)


def test_build_model_serves_moe_and_hybrid_and_refuses_4b():
    """Every family builds: a ``DecoderLM`` for each config but
    Whisper's, an ``EncDecModel`` for it, and each family's training
    batch exists."""
    from repro_torch.data.synthetic import global_batch
    from repro_torch.models import EncDecModel
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        m = build_model(cfg, device="cpu")
        assert isinstance(m, EncDecModel if cfg.is_encdec else DecoderLM)
        batch = global_batch(cfg, 0, 2, 16)
        want = {"tokens", "labels"} | ({"frames"} if cfg.is_encdec else set()) \
            | ({"patches"} if cfg.family == "vlm" else set())
        assert batch.keys() == want, arch
    assert {get_config(a).family for a in list_archs()} == {
        "dense", "moe", "hybrid", "ssm", "encdec", "vlm"}


@pytest.mark.parametrize("init", ["init_flat", "init_device"])
def test_inits_follow_the_mamba_and_moe_rules(init):
    """A_log = log(1..N), D = 1, conv_b = 0, softplus(dt_bias) in
    [1e-3, 1e-1]; ``init_device``'s leaves come in their load dtypes,
    load without a copy and repeat with the seed."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    if init == "init_flat":
        flat = {k: torch.from_numpy(v) for k, v in init_flat(cfg, 3).items()}
    else:
        flat = init_device(cfg, 3, "bfloat16", device="cpu")
    assert flat.keys() == flat_specs(param_specs(cfg)).keys()
    mixer = "g0/s1/mixer/"
    a_log = flat[mixer + "A_log"].float()
    want = torch.log(torch.arange(1, cfg.d_state + 1, dtype=torch.float32))
    assert torch.allclose(a_log, want.expand_as(a_log))
    assert bool((flat[mixer + "D"] == 1).all())
    assert not flat[mixer + "conv_b"].any()
    dt = torch.nn.functional.softplus(flat[mixer + "dt_bias"].float())
    assert float(dt.min()) >= 1e-3 * 0.99 and float(dt.max()) <= 0.1 * 1.01
    if init == "init_device":
        for name, t in flat.items():
            f32 = name.rsplit("/", 1)[-1] in F32_LEAVES
            assert t.dtype == (torch.float32 if f32 else torch.bfloat16)
        tm = DecoderLM(cfg, device="cpu").load_flat(flat)
        got = tm.params["g0"]["s1"]["ffn"]["w_up"]
        assert got.data_ptr() == flat["g0/s1/ffn/w_up"].data_ptr()
        again = init_device(cfg, 3, "bfloat16", device="cpu")
        assert all(torch.equal(again[k], v) for k, v in flat.items())
