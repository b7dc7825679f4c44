"""The training path's gradients on the card: ``flash_attn``'s two routes
(``scaled_dot_product_attention``'s own backward on float32 copies, and
autograd through the plain blocked version) and one ``DecoderLM.loss``
backward of reduced SmolLM on a device against the same on the CPU.
On the CPU the attention case holds the card route, run on CPU
tensors, against the plain version; marked ``cuda``, the cases run on a
card:
    python -m pytest -m cuda tests/test_torch_card_train.py
Tolerances: attention outputs and gradients within 1e-4 of each
tensor's max |value| (float32 sums in other orders); the loss within
1e-5 and every parameter gradient within 1e-3 of its tensor's max |g|
(float32 throughout, TF32 off). This file imports neither the JAX
package nor jax, so it runs on a machine with a card and no jax."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import global_batch  # noqa: E402
from repro_torch.models.attention import flash_attn, \
    flash_attn_plain, flash_attn_sdpa  # noqa: E402
from repro_torch.models.lm import DecoderLM, RunFlags, init_flat  # noqa: E402
from repro_torch.train.step import nest  # noqa: E402

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
CASES = [  # (B, S, Hq, Hkv, hd, window)
    (2, 64, 4, 2, 16, 0),
    (1, 96, 6, 2, 32, 24),
    (2, 48, 4, 4, 16, 0),
]


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device(name)


def _close(got: torch.Tensor, want: torch.Tensor, rel: float):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale


def _attn_grads(fn, q, k, v, dev, **kw):
    qkv = [torch.tensor(a, device=dev, requires_grad=True) for a in (q, k, v)]
    o = fn(*qkv, causal=True, **kw)
    gen = torch.Generator().manual_seed(7)
    w = torch.randn(o.shape, generator=gen).to(dev)
    return o, torch.autograd.grad((o * w).sum(), qkv)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("device", DEVICES)
def test_flash_attn_gradients_match_plain(device, case):
    dev = _device(device)
    B, S, Hq, Hkv, hd, window = CASES[case]
    rng = np.random.default_rng(case)
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
            for _ in range(2))
    route = flash_attn if dev.type == "cuda" else flash_attn_sdpa
    o, grads = _attn_grads(route, q, k, v, dev, window=window)
    o_ref, ref = _attn_grads(flash_attn_plain, q, k, v, "cpu",
                             window=window, q_block=16, kv_block=32)
    _close(o, o_ref, 1e-4)
    for g, r in zip(grads, ref):
        _close(g, r, 1e-4)


@pytest.mark.cuda
def test_loss_and_gradients_on_the_card_match_the_cpu():
    dev = _device("cuda")
    cfg = get_config("smollm-360m").reduced()
    flat = init_flat(cfg, 0)
    batch = global_batch(cfg, 0, 2, 32, seed=0)
    out = []
    for d in ("cpu", dev):
        leaves = {k: torch.tensor(a, device=d, requires_grad=True)
                  for k, a in flat.items()}
        model = DecoderLM(cfg, RunFlags(dtype="float32"), device=d)
        loss = model.loss(nest(leaves), batch)
        out.append((loss, torch.autograd.grad(loss, list(leaves.values()))))
    (loss_cpu, g_cpu), (loss_dev, g_dev) = out
    assert abs(loss_dev.item() - loss_cpu.item()) <= 1e-5
    for a, b in zip(g_dev, g_cpu):
        assert a.dtype == torch.float32
        _close(a, b, 1e-3)
