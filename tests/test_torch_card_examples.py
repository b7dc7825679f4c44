"""The port's examples on the card at small size: ``quickstart`` (reduced
SmolLM-360M, 64 KiB chunks) and ``coldstart_drill`` (8 functions, 60
invocations a phase, (64, 256) tensors, 8 KiB chunks), each through its
``main(argv)``. On the card they must launch their kernels (the SHA-256
and AES kernels in publish, the fused verify+decrypt kernel in every
restore) and give the same counts, stats and restored bytes as the same
``main`` on the CPU. Marked ``cuda``, the card cases run with:
    python -m pytest -m cuda tests/test_torch_card_examples.py
This file imports neither the JAX package nor jax."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.examples import coldstart_drill, quickstart  # noqa: E402

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
QUICKSTART = ["--reduced", "--chunk-size", "65536"]
DRILL = ["--functions", "8", "--invocations", "60", "--rows", "64",
         "--cols", "256", "--chunk-size", "8192"]


def _run(main, argv, device, tmp_path):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.reset_launches()
    out = main(argv + ["--device", device, "--store",
                       str(tmp_path / device)])
    return out, dict(kernels.LAUNCHES)


@pytest.mark.parametrize("device", DEVICES)
def test_quickstart(device, tmp_path):
    got, launches = _run(quickstart.main, QUICKSTART, device, tmp_path)
    assert got["tensor_ok"] and got["half_ok"] and got["restore_after_gc_ok"]
    assert got["deleted_old_root"] and got["migrated_manifests"] == 2
    assert got["fine_tune"]["unique_chunks"] >= 1
    assert got["chunks_touched"] >= 1
    if device == "cuda":
        assert launches["sha256_many"] > 0
        assert launches["aes_encrypt_many"] > 0
        assert launches["fused_verify_decrypt"] >= 2
        want, _ = _run(quickstart.main, QUICKSTART, "cpu", tmp_path)
        assert got == want
    else:
        assert sum(launches.values()) == 0


@pytest.mark.parametrize("device", DEVICES)
def test_coldstart_drill(device, tmp_path):
    got, launches = _run(coldstart_drill.main, DRILL, device, tmp_path)
    ph = got["phases"]
    assert [p["rejected"] for p in ph.values()] == [0, 0, 0, 0]
    assert ph["warmup"]["origin_fraction"] > 0
    assert ph["post-recovery"]["origin_fraction"] <= \
        ph["cold restart"]["origin_fraction"]
    if device == "cuda":
        assert launches["fused_verify_decrypt"] >= 4 * 60
        assert launches["sha256_many"] > 0 and launches["parity"] > 0
        want, _ = _run(coldstart_drill.main, DRILL, "cpu", tmp_path)
        assert got["images"] == want["images"]
        for name, p in ph.items():
            w = want["phases"][name]
            assert (p["reads"], p["l1_hit_rate"], p["origin_fetches"],
                    p["rejected"]) == (w["reads"], w["l1_hit_rate"],
                                       w["origin_fetches"], w["rejected"])
