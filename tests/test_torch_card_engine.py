"""The serve engine with one prompt longer than its ``max_len`` beside
one in range (ROADMAP.md §3, fault 1, repaired). Before the repair the
KV-cache write past the last row raised on the CPU and was a
device-side assert on the card, which failed every slot of the batch.
Reduced smollm-360m from ``init_flat(cfg, 0)``, float32 with TF32 off:
the batch must finish, the in-range slot's tokens must equal a run
without the long request, and the card's tokens the CPU's. Marked
``cuda``, the card case runs with:
    python -m pytest -m cuda tests/test_torch_card_engine.py
This file imports neither the JAX package nor jax."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import DecoderLM, RunFlags, init_flat  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
MAX_LEN = 8
PROMPTS = [list(range(1, 11)), [5, 6]]


def _serve(model, prompts) -> list:
    eng = ServeEngine(model, max_batch=2, max_len=MAX_LEN)
    reqs = [Request(i, prompt=p, max_new=3) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def _model(device: str):
    cfg = get_config("smollm-360m").reduced()
    return DecoderLM(cfg, RunFlags(dtype="float32"), device=device) \
        .load_flat(init_flat(cfg, 0))


@pytest.mark.parametrize("device", DEVICES)
def test_prompt_past_max_len_beside_one_in_range(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _model(device)
    got = _serve(model, PROMPTS)
    assert len(got[0]) == 1 and len(got[1]) == 3
    assert got[1] == _serve(model, PROMPTS[1:])[0]
    if device == "cuda":
        assert got == _serve(_model("cpu"), PROMPTS)
