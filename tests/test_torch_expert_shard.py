"""``expert_shard_restore`` of the port against the JAX package's on
the CPU: one image published by the JAX ``create_image`` of reduced
arctic-480b or jamba-v0.1-52b (the JAX ``DecoderLM.init`` params of
``jax.random.key(0)``) is read by both packages at ``ep_size`` 2.
The expert slices (dim 1 of the stacked ``ffn/w_gate|w_up|w_down``)
are byte-equal and the two ranks' slices make up the whole stacks. The
router and reduced jamba's ``conv_w`` and ``dt_proj`` come back whole
from the port and sliced from the JAX package, which slices any dim
whose size equals the expert count (ROADMAP.md §3)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_families as fam  # noqa: E402
from repro.core.loader import ImageReader, create_image  # noqa: E402
from repro.core.store import ChunkStore as JStore  # noqa: E402
from repro.serve.coldstart import \
    expert_shard_restore as jax_expert_shard_restore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.service import ImageService, \
    ServiceConfig  # noqa: E402
from repro_torch.core.store import ChunkStore  # noqa: E402
from repro_torch.models.lm import flat_specs, param_specs  # noqa: E402
from repro_torch.serve.coldstart import expert_dim, \
    expert_shard_restore  # noqa: E402

KEY = b"F" * 32


def _publish(arch, flat, tmp_path):
    store = tmp_path / "s"
    blob, _ = create_image(flat, tenant="t", tenant_key=KEY,
                           store=JStore(store), root="r0", chunk_size=16384)
    svc = ImageService(ChunkStore(store), ServiceConfig(
        device="cpu", decode_backend="python"))
    return blob, store, svc


@pytest.mark.parametrize("arch,whole", [
    ("arctic-480b", ("g0/s0/ffn/router",)),
    ("jamba-v0.1-52b", ("g0/s1/ffn/router", "g0/s1/mixer/conv_w",
                        "g0/s1/mixer/dt_proj"))])
def test_expert_shard_restore_against_reference(arch, whole, tmp_path):
    flat, _ = fam.jax_params(arch)
    E = get_config(arch).reduced().num_experts
    blob, store, svc = _publish(arch, flat, tmp_path)
    want = jax_expert_shard_restore(ImageReader(blob, KEY, JStore(store)),
                                    E, ep_rank=1, ep_size=2)
    shards = [expert_shard_restore(svc.open(blob, KEY), E, r, 2)
              for r in range(2)]
    got = shards[1]
    assert got.keys() == want.keys() == flat.keys()
    experts = [n for n in flat if n.rsplit("/", 2)[-2:-1] == ["ffn"]
               and n.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down")
               and flat[n].ndim == 4]
    assert experts
    for name, full in flat.items():
        if name in experts:
            assert got[name].tobytes() == full[:, E // 2:].tobytes(), name
            assert got[name].tobytes() == np.asarray(want[name]).tobytes()
            both = np.concatenate([shards[0][name], got[name]], axis=1)
            assert both.tobytes() == full.tobytes(), name
        else:
            assert got[name].tobytes() == full.tobytes(), name
    for name in whole:
        # the JAX package slices these by their size alone
        assert want[name].shape != flat[name].shape, name
        assert got[name].shape == flat[name].shape, name
    svc.close()


def test_expert_dims_of_the_full_jamba_layout():
    """At full width d_state (16) equals jamba's 16 experts: the port
    slices only the expert stacks, never ``A_log`` (1, 8192, 16)."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=8)
    sliced = {n for n, sp in flat_specs(param_specs(cfg)).items()
              if expert_dim(n, sp.shape, cfg.num_experts) is not None}
    assert sliced == {f"g0/s{j}/ffn/{w}" for j in (1, 3, 5, 7)
                      for w in ("w_gate", "w_up", "w_down")}
    a_log = flat_specs(param_specs(cfg))["g0/s1/mixer/A_log"]
    assert a_log.shape == (1, 8192, 16)
