"""The xLSTM, encoder-decoder and VLM families on the card against the
same models on the CPU, and ``flash_attn``'s two routes on
cross-attention shapes (non-causal, fewer queries than keys). Marked
``cuda``, the family cases run on a card:
    python -m pytest -m cuda tests/test_torch_card_families_4b.py
For each of reduced xlstm-350m, whisper-base and pixtral-12b, in
float32 with TF32 off and float32 decode states: the training loss
(no gradient), ``prefill`` (patches for pixtral, frames for whisper)
and three ``decode_step``s, each within 1e-4 of the CPU's max |value|.
On the CPU the attention cases hold the card route, run on CPU
tensors, against the plain blocked version (1e-4 of max |value|). This
file imports neither the JAX package nor jax, so it runs on a machine
with a card and no jax."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import global_batch  # noqa: E402
from repro_torch.models import RunFlags, build_model, init_flat  # noqa: E402
from repro_torch.models.attention import flash_attn, \
    flash_attn_plain, flash_attn_sdpa  # noqa: E402
from repro_torch.train.step import nest  # noqa: E402

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
CROSS = [  # (B, Sq, Skv, Hq, Hkv, hd)
    (2, 12, 40, 4, 2, 16),
    (1, 7, 300, 8, 8, 8),
    (2, 33, 150, 4, 4, 16),
]
ARCHS = ["xlstm-350m", "whisper-base", "pixtral-12b"]


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device(name)


def _close(got: torch.Tensor, want: torch.Tensor, rel: float = 1e-4):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale


@pytest.mark.parametrize("case", range(len(CROSS)))
@pytest.mark.parametrize("device", DEVICES)
def test_cross_attention_routes_agree(device, case):
    dev = _device(device)
    B, Sq, Skv, Hq, Hkv, hd = CROSS[case]
    rng = np.random.default_rng(case)
    q = torch.from_numpy(rng.standard_normal((B, Sq, Hq, hd), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Skv, Hkv, hd),
                                                 np.float32))
            for _ in range(2))
    route = flash_attn if dev.type == "cuda" else flash_attn_sdpa
    got = route(q.to(dev), k.to(dev), v.to(dev), causal=False)
    want = flash_attn_plain(q, k, v, causal=False, q_block=8, kv_block=64)
    _close(got, want)


def _run(arch: str, dev) -> dict:
    """Loss, prefill logits (and cross k/v) and three decode steps'
    logits of the reduced `arch` on `dev`, float32."""
    cfg = get_config(arch).reduced()
    m = build_model(cfg, RunFlags(dtype="float32"), device=dev)
    flat = init_flat(cfg, 0)
    m.load_flat(flat)
    batch = global_batch(cfg, 0, 2, 16, seed=0)
    out = {"loss": m.loss(nest({k: torch.from_numpy(v).to(dev)
                                for k, v in flat.items()}), batch)}
    if cfg.is_encdec:
        pre, rows = {"frames": batch["frames"]}, 0
    else:
        pre = {k: v for k, v in batch.items() if k != "labels"}
        rows = batch["tokens"].shape[1] + (cfg.num_patches
                                           if "patches" in batch else 0)
    st = m.init_decode_state(2, 64, torch.float32)
    out["prefill"], st = m.prefill(
        {k: torch.from_numpy(v).to(dev) for k, v in pre.items()}, st)
    if cfg.is_encdec:
        out["cross_k"] = st["s1"]["k"]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 2))
    for i, t in enumerate(toks):
        out[f"decode{i}"], st = m.decode_step(
            st, torch.from_numpy(t).to(dev), torch.full((2,), rows + i,
                                                        device=dev))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_family_on_the_card_matches_the_cpu(arch):
    dev = _device("cuda")
    with torch.no_grad():
        got, want = _run(arch, dev), _run(arch, torch.device("cpu"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device.type == "cuda", k
        _close(got[k], want[k])
