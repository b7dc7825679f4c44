"""The small helpers of ROADMAP.md §1 item 7.3 in the port against the
JAX package, on the CPU, on the same inputs: ``chunk_name``,
``Manifest.unique_names``, ``RootPinRegistry.count``,
``ExpiredRootRead``, the decode registry's ``registered_backends`` and
``get_backend`` with their hook properties, ``ImageService``'s
``admission=`` and ``counters=``, ``PublishPipeline.copy_chunks``'s
``parallelism=``, ``image_id_for`` on raw bytes, the numpy lockstep
``sha256_many_np``, ``count_params`` and the serving step factories.
Tolerance: exact (bytes, names, counts), float32 logits bit for bit
where both sides run the same port code."""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import jax_params  # noqa: E402

from repro.core import gc as jgc  # noqa: E402
from repro.core import publish as jpub  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro.core.crypto import convergent as jconv  # noqa: E402
from repro.core.crypto import sha256v as jsha  # noqa: E402
from repro.core.loader import create_image  # noqa: E402
from repro.core.manifest import open_manifest as jopen  # noqa: E402
from repro.models.common import count_params as jcount  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import decode, gc, publish, store  # noqa: E402
from repro_torch.core.concurrency import RejectingLimiter  # noqa: E402
from repro_torch.core.crypto import convergent  # noqa: E402
from repro_torch.core.crypto import sha256v  # noqa: E402
from repro_torch.core.manifest import open_manifest  # noqa: E402
from repro_torch.core.service import ColdStartRejected, ImageService, \
    ServiceConfig  # noqa: E402
from repro_torch.core.telemetry import Counters  # noqa: E402
from repro_torch.models import DecoderLM, RunFlags, init_flat  # noqa: E402
from repro_torch.models.common import count_params  # noqa: E402
from repro_torch.train.step import make_decode_step, \
    make_prefill_step  # noqa: E402

KEY = b"H" * 32
LENGTHS = (0, 1, 55, 56, 63, 64, 65, 119, 128, 1000, 4096)


def test_chunk_name_and_sha256_many_np_match_jax():
    rng = np.random.default_rng(0)
    datas = [rng.integers(0, 256, n, np.uint8).tobytes() for n in LENGTHS]
    for d in datas:
        assert convergent.chunk_name(d) == jconv.chunk_name(d) == \
            hashlib.sha256(d).hexdigest()
    want = [hashlib.sha256(d).digest() for d in datas]
    assert sha256v.sha256_many_np(datas) == jsha.sha256_many_np(datas) == want
    assert sha256v.sha256_many(datas, backend="numpy") == want
    assert sha256v.sha256_many(datas) == want
    assert sha256v.sha256_many_np([]) == []


def test_image_ids_and_unique_names_match_jax(tmp_path):
    for blob in (b"", b"abc", bytes(range(256)) * 9):
        assert publish.image_id_for(blob) == jpub.image_id_for(blob)
    tree = {"a": np.arange(600, dtype=np.float32),
            "b": np.zeros(700, np.float32),
            "c": np.tile(np.arange(64, dtype=np.float32), 20)}
    assert publish.image_id_for(tree) == jpub.image_id_for(tree)
    blob, _ = create_image(tree, tenant="t", tenant_key=KEY,
                           store=jstore.ChunkStore(tmp_path / "s"),
                           root="r0", chunk_size=256)
    names = open_manifest(blob, KEY).unique_names
    assert names == jopen(blob, KEY).unique_names
    assert names == sorted(set(names)) and "__zero__" not in names


def test_pin_count_and_expired_root_read_match_jax():
    for mod in (gc, jgc):
        pins = mod.RootPinRegistry()
        assert pins.count("r") == 0
        with pins.pin("r"):
            with pins.pin("r"):
                assert pins.count("r") == 2
            assert pins.count("r") == 1 and pins.pinned("r")
        assert pins.count("r") == 0
    assert issubclass(store.ExpiredRootRead, Exception)
    assert issubclass(jstore.ExpiredRootRead, Exception)


def test_registry_helpers():
    reg = decode.registered_backends()
    assert list(reg) == ["python", "torch", "torch-fused"]
    reg.clear()                                   # a copy
    assert decode.get_backend("fused") is decode.get_backend("torch-fused")
    assert decode.get_backend("auto").name == "torch-fused"
    assert decode.get_backend("numpy").name == "python"
    py = decode.get_backend("python")
    assert (py.encrypt_many, py.sha_many, py.fused) == (None, None, None)
    fused = decode.get_backend("torch-fused")
    # bound to the card by default; ``hooks("cpu")`` binds the plain
    # versions
    assert str(fused.fused.keywords["device"]) == "cuda"
    assert str(fused.encrypt_many.keywords["device"]) == "cuda"
    assert decode.get_backend("torch").fused is None
    assert str(fused.hooks("cpu")[1].keywords["device"]) == "cpu"
    with pytest.raises(ValueError):
        decode.get_backend("nope")


def test_service_takes_admission_and_counters(tmp_path):
    lim = RejectingLimiter(1)
    sink = Counters()
    svc = ImageService(store.ChunkStore(tmp_path / "s"),
                       ServiceConfig(device="cpu", max_coldstarts=5),
                       admission=lim, counters=sink)
    assert svc.admission is lim and svc.counters is sink
    with svc.admission_slot():
        with pytest.raises(ColdStartRejected):
            with svc.admission_slot():
                pass
    assert (lim.admitted, lim.rejected) == (1, 1)
    assert sink.get("serve.coldstart_rejected") == 1
    svc.tenant_counters("t").inc("x")
    assert sink.get("tenant.t::x") == 1
    svc.close()


@pytest.mark.parametrize("parallelism", [None, 1, 3])
def test_copy_chunks_parallelism(tmp_path, parallelism):
    """A GC migration copy of a JAX-made image runs `parallelism`
    copies at a time (None: ``upload_parallelism``), copies each
    distinct chunk once, and the JAX store finds them all."""
    tree = {"w": np.random.default_rng(1).standard_normal(3000)}
    blob, _ = create_image(tree, tenant="t", tenant_key=KEY,
                           store=jstore.ChunkStore(tmp_path / "s"),
                           root="r0", chunk_size=512)
    names = jopen(blob, KEY).unique_names
    svc = ImageService(store.ChunkStore(tmp_path / "s"),
                       ServiceConfig(device="cpu", decode_backend="python"))
    pipe = svc.publisher()
    seen = []
    get = pipe._pool.get
    pipe._pool.get = lambda n: seen.append(n) or get(n)
    assert pipe.copy_chunks("r0", "r1", names + names[:3],
                            parallelism=parallelism) == len(names)
    assert seen == [parallelism or pipe.upload_parallelism]
    assert pipe.copy_chunks("r0", "r1", names) == 0
    js = jstore.ChunkStore(tmp_path / "s")
    assert js.has_chunks("r1", names) == set(names)
    svc.close()


def test_count_params_matches_jax():
    flat, params = jax_params("smollm-360m")
    cfg = get_config("smollm-360m").reduced()
    model = DecoderLM(cfg, RunFlags(dtype="float32"), device="cpu")
    model.load_flat(flat)
    assert count_params(model.params) == jcount(params) == \
        count_params(flat) == sum(a.size for a in flat.values())
    assert count_params(model.param_shapes()) == jcount(params)


def test_serving_step_factories():
    """``prefill_step``/``decode_step`` with the model's own weights are
    its ``prefill``/``decode_step``; given other weights they serve
    those, as a model loaded with them does."""
    cfg = get_config("smollm-360m").reduced()
    a, b = init_flat(cfg, 0), init_flat(cfg, 1)
    model = DecoderLM(cfg, RunFlags(dtype="float32"), device="cpu")
    other = DecoderLM(cfg, RunFlags(dtype="float32"), device="cpu")
    model.load_flat(a)
    other.load_flat(b)
    toks = torch.tensor([[3, 1, 4, 1], [5, 9, 2, 6]])
    prefill, step = make_prefill_step(model), make_decode_step(model)
    outs = []
    for params, ref in ((model.params, model), (b, other)):
        st, rst = (m.init_decode_state(2, 8, dtype=torch.float32)
                   for m in (model, ref))
        lg, st = prefill(params, {"tokens": toks}, st)
        rlg, rst = ref.prefill({"tokens": toks}, rst)
        assert torch.equal(lg, rlg)
        nxt, pos = lg.argmax(-1), torch.tensor([4, 4])
        lg, _ = step(params, st, nxt, pos)
        rlg, _ = ref.decode_step(rst, nxt, pos)
        assert torch.equal(lg, rlg)
        outs.append(lg)
    assert not torch.equal(outs[0], outs[1])
    # the second call loaded `b`: the model now serves it
    assert torch.equal(model.params["embed"], other.params["embed"])

