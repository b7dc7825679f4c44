"""The port's erasure coder and the plain PyTorch versions of its two
kernels (XOR parity, GF(256) matrix product) against the JAX package:
its numpy ``ErasureCoder`` and ``gf_matmul``, and its parity and
Reed-Solomon Pallas kernels in interpret mode. Tolerance: exact bytes.
The CUDA kernels themselves run on the card in
``tests/test_torch_card_l2.py``, which imports no jax."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import erasure as jer  # noqa: E402
from repro.kernels.gf256.ops import \
    rs_matmul_fn as jax_rs_matmul_fn  # noqa: E402
from repro.kernels.parity.ops import \
    parity_fn_for_erasure as jax_parity_fn  # noqa: E402
from repro_torch.core import erasure as ter  # noqa: E402
from repro_torch.core.telemetry import COUNTERS  # noqa: E402
from repro_torch.kernels.gf256 import ops as gops  # noqa: E402
from repro_torch.kernels.parity import ops as pops  # noqa: E402

RNG = np.random.default_rng(1206)
CHUNK_LENS = [0, 1, 5, 4095, 4096, 131073]
STRIPE_LENS = [0, 1, 3, 5, 15, 16, 17, 4099]
ALL_COEFFS = np.arange(256, dtype=np.uint8).reshape(16, 16)


def _rand(*shape):
    return RNG.integers(0, 256, shape, dtype=np.uint8)


def _port_coder(k, n):
    return ter.ErasureCoder(k, n,
                            parity_fn=pops.parity_fn_for_erasure("cpu"),
                            matmul_fn=gops.rs_matmul_fn("cpu"))


def test_field_and_matrices_match_jax():
    assert np.array_equal(ter._EXP, jer._EXP)
    assert np.array_equal(ter._LOG, jer._LOG)
    for k, n in [(4, 5), (4, 6), (3, 7)]:
        m = ter.encode_matrix(k, n)
        assert np.array_equal(m, jer.encode_matrix(k, n))
        for idx in itertools.combinations(range(n), k):
            assert np.array_equal(ter._gf_matinv(m[list(idx)]),
                                  jer._gf_matinv(m[list(idx)]))
    d = _rand(16, 333)
    assert np.array_equal(ter.gf_matmul(ALL_COEFFS, d),
                          jer.gf_matmul(ALL_COEFFS, d))


@pytest.mark.parametrize("k, n, patterns", [
    (4, 5, list(itertools.combinations(range(5), 4))),
    (4, 6, [(0, 1, 2, 3), (0, 1, 2, 4), (1, 2, 3, 5), (0, 2, 4, 5),
            (2, 3, 4, 5)]),
])
def test_coder_matches_jax(k, n, patterns):
    """encode, decode and decode_many, every length against every
    erasure pattern, the port with its CPU kernel hooks."""
    tc, jc = _port_coder(k, n), jer.ErasureCoder(k, n)
    chunks = [_rand(n_).tobytes() for n_ in CHUNK_LENS]
    batch, lens = [], []
    for chunk in chunks:
        stripes = tc.encode(chunk)
        assert stripes == jc.encode(chunk)
        for keep in patterns:
            sub = {i: stripes[i] for i in keep}
            assert tc.decode(sub, len(chunk)) == chunk
            assert jc.decode(sub, len(chunk)) == chunk
            batch.append(sub)
            lens.append(len(chunk))
    want = [c for c in chunks for _ in patterns]
    assert tc.decode_many(batch, lens) == want
    assert jc.decode_many(batch, lens) == want
    with pytest.raises(ValueError):
        tc.decode_many([{0: b"", 1: b""}], [0])


def test_plain_parity_matches_jax_pallas_interpret():
    fn = pops.parity_fn_for_erasure("cpu")
    for L in STRIPE_LENS:
        d = _rand(4, L)
        assert np.array_equal(fn(d), d[0] ^ d[1] ^ d[2] ^ d[3])
    jfn = jax_parity_fn(interpret=True)
    for L in (5, 4099):
        d = _rand(4, L)
        assert np.array_equal(fn(d), jfn(d))


def test_plain_gf_matmul_matches_jax_pallas_interpret_and_numpy():
    fn = gops.rs_matmul_fn("cpu")
    rows = jer.encode_matrix(4, 6)[4:]
    d = _rand(4, 1001)
    jfn = jax_rs_matmul_fn(interpret=True)
    assert np.array_equal(fn(rows, d), jfn(rows, d))
    assert np.array_equal(gops.rs_parity_fn(rows, "cpu")(d),
                          jer.gf_matmul(rows, d))
    for L in STRIPE_LENS:
        d = _rand(16, L)
        assert np.array_equal(fn(ALL_COEFFS, d), jer.gf_matmul(ALL_COEFFS, d))
    m = _rand(8, 8)
    d = _rand(8, 77)
    assert np.array_equal(fn(m, d), jer.gf_matmul(m, d))


@pytest.mark.parametrize("wrapper", ["parity", "gf256"])
def test_wrappers_take_plain_version_only_for_cpu_tensors(wrapper):
    """A tensor that is not on the CPU never reaches the plain version:
    a non-CUDA device raises, and a wrong dtype or shape raises too."""
    if wrapper == "parity":
        def call(dev, dtype=torch.uint8):
            return pops.parity(torch.zeros(4, 16, dtype=dtype, device=dev))
    else:
        def call(dev, dtype=torch.uint8):
            return gops.gf_matmul(torch.ones(2, 4, dtype=dtype, device=dev),
                                  torch.zeros(4, 16, dtype=dtype, device=dev))
        with pytest.raises(ValueError):
            gops.gf_matmul(torch.ones(2, 3, dtype=torch.uint8),
                           torch.zeros(4, 16, dtype=torch.uint8))
    assert not call("cpu").any()
    with pytest.raises(ValueError):
        call("meta")
    with pytest.raises(TypeError):
        call("cpu", torch.int32)


def _lost(k, n, drop):
    return [(k, n, lost, clen) for lost in drop
            for clen in (524288, 524281, 1000)]


@pytest.mark.parametrize("k, n, lost, clen", _lost(
    4, 5, [(i,) for i in range(5)]) + _lost(
    4, 6, [(0, 1), (2, 5), (1, 4), (4, 5)]))
def test_decode_matches_jax_byte_for_byte(k, n, lost, clen):
    """The per-chunk ``decode`` (4-of-5: a lost data stripe is the XOR of
    the four in hand; 4-of-6: the cached GF(256) inverse) equals the JAX
    package's ``decode`` and the port's ``decode_many``, and counts a
    rebuild exactly where a parity stripe is among the four."""
    tc, jc = _port_coder(k, n), jer.ErasureCoder(k, n)
    chunk = _rand(clen).tobytes()
    stripes = tc.encode(chunk)
    sub = {i: s for i, s in enumerate(stripes) if i not in lost}
    before = COUNTERS.get("l2.parity_rebuilds")
    got = tc.decode(sub, clen)
    rebuilt = sorted(sub)[k - 1] >= k
    assert COUNTERS.get("l2.parity_rebuilds") - before == rebuilt
    assert got == jc.decode(sub, clen) == chunk
    assert type(got) is bytes
    assert tc.decode(sub, clen) == got          # the cached inverse, again
    assert set(tc._inverses) == ({tuple(sorted(sub)[:k])}
                                 if rebuilt and n - k > 1 else set())
    assert tc.decode_many([sub, dict(sub)], [clen, clen]) == [got, got]
