"""The port's serve launcher (``repro_torch.launch.serve``) on the CPU:
its flags against the JAX launcher's (read from that file's source,
not run), the ``--publish`` path, the ``--store/--image/--no-reduced``
path, every flag group in one run, and ``build_model``'s families. The
launcher's greedy tokens must equal a ``ServeEngine`` over the same
``init_flat`` weights loaded directly."""
import argparse
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_launch import reference_flags  # noqa: E402

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.service import ImageService, \
    ServiceConfig  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import DecoderLM, EncDecModel, build_model, \
    init_flat  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

REF = Path(__file__).resolve().parents[1] / "src/repro/launch/serve.py"
# the documented divergences (module doc of the port's launcher)
ADDED = {"--device"}
DROPPED = {"--jax-compile-cache"}
DEFAULTS = {"--decode-backend": ("numpy", "torch-fused")}
CPU = ["--device", "cpu", "--decode-backend", "python"]


def _reference_flags() -> dict:
    """{flag: (default, action)} of every ``add_argument`` in the JAX
    launcher's source."""
    return reference_flags(REF)


def test_flags_match_the_reference():
    ref = _reference_flags()
    port = {a.option_strings[0]: a for a in serve.build_parser()._actions
            if a.option_strings and a.dest != "help"}
    assert set(port) == (set(ref) - DROPPED) | ADDED
    for flag, (default, action) in ref.items():
        if flag in DROPPED:
            continue
        want = DEFAULTS[flag][1] if flag in DEFAULTS else default
        assert DEFAULTS.get(flag, (default,))[0] == default, flag
        assert port[flag].default == want, flag
    # --reduced: store_true with default True cannot be turned off
    assert ref["--reduced"] == (True, "store_true")
    assert isinstance(port["--reduced"], argparse.BooleanOptionalAction)
    p = serve.build_parser()
    assert p.parse_args(["--arch", "x"]).reduced is True
    assert p.parse_args(["--arch", "x", "--no-reduced"]).reduced is False
    assert p.parse_args(["--arch", "x"]).device == "cuda"


def _direct_tokens(cfg, requests, max_new, seed=0):
    model = build_model(cfg, device="cpu").load_flat(init_flat(cfg, seed))
    eng = ServeEngine(model, max_batch=4, max_len=64)
    reqs = [Request(i, prompt=[1 + i, 2, 3], max_new=max_new)
            for i in range(requests)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [r.out for r in reqs]


def test_publish_path_serves_every_request(capsys):
    out = serve.main(["--arch", "smollm-360m", "--requests", "2",
                      "--max-new", "2", "--l2-nodes", "0", "--publish",
                      "--eager-flush", *CPU])
    assert out["served"] == out["requests"] == 2
    assert all(len(t) == 2 for t in out["tokens"])
    assert out["tokens"] == _direct_tokens(
        get_config("smollm-360m").reduced(), 2, 2)
    cs = out["cold_start"]
    assert "eager_flushes" in cs and cs["load_seconds"] > 0
    assert out["tile_bytes"] > 0
    text = capsys.readouterr().out
    assert "published" in text and "served 2/2 requests" in text


def test_every_flag_group_serves(capsys):
    """L2, a peer mesh with a crashed peer, retries, the breaker, a
    flaky origin, eager flush with a minimum, a pinned tile."""
    out = serve.main(["--arch", "starcoder2-15b", "--requests", "3",
                      "--max-new", "3", "--l2-nodes", "6",
                      "--peer-workers", "2", "--peer-fault", "1:crashed",
                      "--retry-attempts", "3", "--breaker-threshold", "0.5",
                      "--origin-fault", "error_p=0.02,delay_ms=1",
                      "--eager-flush", "--eager-min-bytes", "0",
                      "--max-batch-bytes", "131072", "--read-path", "staged",
                      *CPU])
    assert out["served"] == 3
    assert out["tile_bytes"] == 131072
    assert out["tokens"] == _direct_tokens(
        get_config("starcoder2-15b").reduced(), 3, 3)
    text = capsys.readouterr().out
    assert "origin fault injection" in text and "peer mesh: 2" in text
    assert serve.origin_fault_plan("unavailable").kind == "unavailable"


TINY = ModelConfig(name="tiny-full", family="dense", num_layers=2,
                   d_model=48, num_heads=3, num_kv_heads=1, head_dim=16,
                   d_ff=96, vocab_size=300, tie_embeddings=True)


def test_store_image_no_reduced_restores_published_image(tmp_path,
                                                         monkeypatch):
    """An image published at a config's full width is served with
    ``--no-reduced``; the default ``--reduced`` model cannot load it."""
    monkeypatch.setattr(serve, "get_config", lambda arch: TINY)
    svc = ImageService(ChunkStore(tmp_path), ServiceConfig(
        device="cpu", root="R1", decode_backend="python"))
    svc.publish(init_flat(TINY, 0), tenant="serve",
                tenant_key=serve.TENANT_KEY, image_id="tiny")
    svc.close()
    argv = ["--arch", "tiny-full", "--store", str(tmp_path), "--image",
            "tiny", "--root", "R1", "--requests", "2", "--max-new", "3",
            "--l2-nodes", "0", *CPU]
    out = serve.main(argv + ["--no-reduced"])
    assert out["config"] == "tiny-full" and out["served"] == 2
    assert out["cold_start"]["origin_fetches"] > 0
    assert out["tokens"] == _direct_tokens(TINY, 2, 3)
    with pytest.raises((KeyError, ValueError)):
        serve.main(argv)


def test_build_model_builds_dense_and_refuses_other_families():
    """Every registered config builds, the JAX registry's ten: a
    ``DecoderLM`` for each family but the encoder-decoder one, whose
    model is an ``EncDecModel``."""
    from repro.configs.registry import list_archs as jax_archs
    assert list_archs() == jax_archs()
    for arch in list_archs():
        cfg = get_config(arch)
        m = build_model(cfg.reduced(), device="cpu")
        assert isinstance(m, EncDecModel if cfg.is_encdec else DecoderLM)
        assert m.device.type == "cpu"


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b",
                                  "jamba-v0.1-52b"])
def test_publish_path_serves_moe_and_hybrid(arch, capsys):
    """The reduced ``--publish`` launcher of each MoE and hybrid config
    serves every request with the tokens of the same ``init_flat``
    weights loaded directly."""
    out = serve.main(["--arch", arch, "--requests", "3", "--max-new", "3",
                      "--publish", *CPU])
    assert out["config"] == arch + "-reduced"
    assert out["served"] == out["requests"] == 3
    assert out["tokens"] == _direct_tokens(get_config(arch).reduced(), 3, 3)
    assert "served 3/3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch,publish", [
    ("xlstm-350m", True), ("whisper-base", True), ("whisper-base", False),
    ("pixtral-12b", True)])
def test_launcher_serves_the_xlstm_encdec_and_vlm_families(arch, publish,
                                                           capsys):
    """The reduced launcher of xlstm-350m, whisper-base (an
    ``EncDecModel``, imaged by ``--publish`` or by ``create_image`` of
    ``init_flat``) and pixtral-12b serves every request with the tokens
    of the same weights loaded directly."""
    argv = ["--arch", arch, "--requests", "3", "--max-new", "3",
            "--l2-nodes", "0", *CPU]
    out = serve.main(argv + (["--publish"] if publish else []))
    assert out["config"] == arch + "-reduced"
    assert out["served"] == out["requests"] == 3
    assert out["tokens"] == _direct_tokens(get_config(arch).reduced(), 3, 3)
