"""The port's training launcher (``repro_torch.launch.train``) and its
variants and data on the CPU: the flags against the JAX launcher's
(read from that file's source, not run), a ``--reduced`` run followed
by ``--resume`` (which must start where the first run's last checkpoint
left it and print the JAX launcher's lines), ``VARIANTS`` equal to the
JAX package's, ``get_variant``'s flags, optimizer overrides and
``ShardingPolicy`` equal to the JAX one's for every variant (each of
which builds its model), and ``global_batch`` equal to the JAX one for dense configs
(exact)."""
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_launch import reference_flags  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.data.synthetic import global_batch as jax_batch  # noqa: E402
from repro.launch.variants import VARIANTS as JVARIANTS  # noqa: E402
from repro.launch.variants import get_variant as jax_variant  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.data.synthetic import Prefetcher, global_batch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.variants import VARIANTS, get_variant  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import RunFlags  # noqa: E402
from repro_torch.sharding.rules import DEFAULT_RULES, ShardingPolicy  # noqa: E402

REF = Path(__file__).resolve().parents[1] / "src/repro/launch/train.py"
# the documented divergences (module doc of the port's launcher)
ADDED = {"--device"}
DROPPED = {"--perf-flags"}
LINE = re.compile(r"step +\d+  loss -?[\d.]+  gnorm [\d.]+  [\d.]+s")


def test_flags_match_the_reference():
    ref = reference_flags(REF)
    port = {a.option_strings[0]: a for a in train.build_parser()._actions
            if a.option_strings and a.dest != "help"}
    assert set(port) == (set(ref) - DROPPED) | ADDED
    for flag, (default, _action) in ref.items():
        if flag not in DROPPED:
            assert port[flag].default == default, flag
    assert train.build_parser().parse_args(["--arch", "x"]).device == "cuda"


def test_reduced_run_then_resume(tmp_path, capsys):
    argv = ["--arch", "smollm-360m", "--reduced", "--steps", "2",
            "--ckpt-every", "2", "--batch", "2", "--seq", "16",
            "--variant", "opt8bit", "--store", str(tmp_path),
            "--device", "cpu"]
    first = train.main(argv)
    assert [h["step"] for h in first] == [2]
    text = capsys.readouterr().out.splitlines()
    assert text[0] == "training smollm-360m [opt8bit] from step 0"
    assert LINE.fullmatch(text[1]) and text[2].startswith(
        "checkpoints: [(2, ")
    second = train.main(argv + ["--resume"])
    assert [h["step"] for h in second] == [4]
    text = capsys.readouterr().out.splitlines()
    assert text[0] == "training smollm-360m [opt8bit] from step 2"
    assert LINE.fullmatch(text[1]) and text[2].startswith(
        "checkpoints: [(4, ")
    assert np.isfinite(second[0]["loss"])


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-base",
                                  "pixtral-12b"])
def test_reduced_run_then_resume_of_the_other_families(arch, tmp_path,
                                                       capsys):
    """The xLSTM, encoder-decoder (frames) and VLM (patches) families
    train, checkpoint and resume through the launcher."""
    argv = ["--arch", arch, "--reduced", "--steps", "2", "--ckpt-every",
            "2", "--batch", "2", "--seq", "16", "--store", str(tmp_path),
            "--device", "cpu"]
    first = train.main(argv)
    assert [h["step"] for h in first] == [2]
    second = train.main(argv + ["--resume"])
    assert [h["step"] for h in second] == [4]
    text = capsys.readouterr().out.splitlines()
    assert f"training {arch} [baseline] from step 2" in text
    assert np.isfinite(second[0]["loss"])


def test_chunked_loss_variant_refuses_the_default_seq():
    """`chunked_loss` sets a 512-token loss chunk; the launcher's default
    --seq 64 is no multiple of it, and the run must stop, not train on
    a loss of zero."""
    with pytest.raises(ValueError, match="multiple of the loss chunk 512"):
        train.main(["--arch", "smollm-360m", "--reduced", "--steps", "1",
                    "--batch", "1", "--variant", "chunked_loss",
                    "--device", "cpu"])


def test_variants_match_the_reference():
    assert VARIANTS == JVARIANTS
    cfg = get_config("smollm-360m")
    policy, flags, opt = get_variant("remat_dots", cfg, SHAPES["train_4k"])
    assert flags == RunFlags(remat="dots") and opt == {}
    assert policy == ShardingPolicy(name="remat_dots")
    policy, flags, opt = get_variant("opt8bit", cfg, SHAPES["train_4k"])
    assert opt == {"moments": "int8"} and flags == RunFlags()
    policy, _, _ = get_variant("fsdp_pods", cfg, SHAPES["train_4k"])
    assert policy.rules == dict(DEFAULT_RULES, fsdp=("pod", "data"))
    for name in VARIANTS:
        policy, flags, opt = get_variant(name, cfg, SHAPES["train_4k"])
        jpolicy, jflags, jopt = jax_variant(name, jax_config(cfg.name),
                                            JSHAPES["train_4k"])
        assert isinstance(policy, ShardingPolicy)
        assert (policy.name, policy.rules) == (jpolicy.name, jpolicy.rules)
        assert flags.__dict__ == jflags.__dict__ and opt == jopt
        build_model(cfg.reduced(), flags, device="cpu")
    assert {k: tuple(v.__dict__.values()) for k, v in SHAPES.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ["smollm-360m", "arctic-480b",
                                  "jamba-v0.1-52b"])
def test_global_batch_matches_jax(arch):
    for reduced in (True, False):
        cfg, jcfg = get_config(arch), jax_config(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        for step in (0, 7):
            got = global_batch(cfg, step, 3, 33, seed=5)
            want = jax_batch(jcfg, step, 3, 33, seed=5)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_applicable_shapes_match_the_reference():
    """``is_subquadratic`` and ``applicable_shapes`` of every arch equal
    the JAX package's: ``long_500k`` for the SSM and hybrid families."""
    from repro.configs.base import applicable_shapes as japplicable
    from repro_torch.configs import applicable_shapes, list_archs
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert cfg.is_subquadratic == jcfg.is_subquadratic, arch
        assert [s.name for s in applicable_shapes(cfg)] == \
            [s.name for s in japplicable(jcfg)], arch
    assert "long_500k" in [s.name for s in applicable_shapes(
        get_config("xlstm-350m"))]


def test_prefetcher_yields_steps_in_order():
    cfg = get_config("smollm-360m").reduced()
    pf = Prefetcher(lambda s: global_batch(cfg, s, 2, 8), start_step=3)
    for want in (3, 4, 5):
        step, batch = pf.next()
        assert step == want
        np.testing.assert_array_equal(batch["tokens"],
                                      global_batch(cfg, want, 2, 8)["tokens"])
    pf.stop()
    vlm = get_config("pixtral-12b").reduced()
    batch = global_batch(vlm, 0, 1, 12)
    assert batch["tokens"].shape == (1, 12 - vlm.num_patches)
    assert batch["patches"].shape == (1, vlm.num_patches, vlm.d_model)
