"""The port's two erasure kernels (XOR parity, GF(256) matrix product) on
the inputs that make them risky: k off the L2's 4 (k = 1 and 9 take the
runtime-k loop, 2..8 the compiled ones), stripe lengths that are not
multiples of 16 bytes, and data whose base is off the 16-byte grid.
Oracles: numpy XOR and the port's ``erasure.gf_matmul``; exact bytes.

Each case runs on the CPU through the plain versions and, marked
``cuda``, through the kernels on a card:

    python -m pytest -m cuda tests/test_torch_card_l2.py

This file imports neither the JAX package nor jax, so it runs on a
machine with a card and no jax."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import erasure  # noqa: E402
from repro_torch.kernels.gf256 import ops as gops  # noqa: E402
from repro_torch.kernels.parity import ops as pops  # noqa: E402

RNG = np.random.default_rng(1206)
STRIPE_LENS = [0, 1, 3, 5, 15, 16, 17, 4099]
ALL_COEFFS = np.arange(256, dtype=np.uint8).reshape(16, 16)
STRIPE = 131072                     # a 512 KiB chunk's 4-of-5 stripe
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _rand(*shape):
    return RNG.integers(0, 256, shape, dtype=np.uint8)


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device(name)


def _check_parity(t: torch.Tensor, d: np.ndarray) -> None:
    got = pops.parity(t)
    assert got.shape == (d.shape[1],)
    assert np.array_equal(got.cpu().numpy(), np.bitwise_xor.reduce(d, axis=0))
    if t.is_cuda:
        assert torch.equal(got, pops.parity_plain(t))


@pytest.mark.cuda
def test_parity_kernel_on_card():
    _device("cuda")
    from repro_torch import kernels
    before = kernels.LAUNCHES["parity"]
    for L in STRIPE_LENS + [131072]:
        d = torch.from_numpy(_rand(4, L)).cuda()
        assert torch.equal(pops.parity(d), pops.parity_plain(d))
    assert kernels.LAUNCHES["parity"] == before + len(STRIPE_LENS)


@pytest.mark.cuda
def test_gf256_kernel_on_card():
    _device("cuda")
    from repro_torch import kernels
    before = kernels.LAUNCHES["gf256"]
    mats = [erasure.encode_matrix(4, 6)[4:], _rand(8, 8), ALL_COEFFS]
    for L in STRIPE_LENS[1:] + [131072]:
        for m in mats:
            mt = torch.from_numpy(m).cuda()
            d = torch.from_numpy(_rand(m.shape[1], L)).cuda()
            assert torch.equal(gops.gf_matmul(mt, d),
                               gops.gf_matmul_plain(mt, d))
    assert kernels.LAUNCHES["gf256"] == before + len(STRIPE_LENS) * len(mats)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 9])
def test_parity_odd_k(device, k):
    """k rows on every stripe length (a 4099-byte stripe on the CPU, the
    L2's 131072 and one byte more on the card)."""
    dev = _device(device)
    long = [STRIPE, STRIPE + 1] if dev.type == "cuda" else [4099]
    for L in STRIPE_LENS + long:
        d = _rand(k, L)
        _check_parity(torch.from_numpy(d).to(dev), d)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("offset", [1, 4, 8])
def test_parity_unaligned_base(device, offset):
    """Data that starts `offset` bytes past a 16-byte boundary (a view
    into a larger buffer), against an output on the grid: the kernel
    takes the widest vector both offsets allow (bytes at offset 1)."""
    dev = _device(device)
    for L in [1, 15, 16, 17, 48, 4096, 4099] + \
            ([STRIPE, STRIPE + 1] if dev.type == "cuda" else []):
        d = _rand(4, L)
        buf = torch.zeros(4 * L + offset, dtype=torch.uint8, device=dev)
        t = buf[offset:].view(4, L)
        t.copy_(torch.from_numpy(d))
        assert t.data_ptr() % 16 == (buf.data_ptr() + offset) % 16
        _check_parity(t, d)


@pytest.mark.cuda
def test_parity_output_is_fresh_on_card():
    """The wrapper's output is a fresh contiguous tensor on the 16-byte
    grid, whatever the data's offset."""
    _device("cuda")
    buf = torch.zeros(4 * STRIPE + 1, dtype=torch.uint8, device="cuda")
    t = buf[1:].view(4, STRIPE)
    out = pops.parity(t)
    assert out.data_ptr() % 16 == 0
    assert out.is_contiguous() and out.shape == (STRIPE,)
