"""The logical-axis spec trees of the port against the JAX package's,
exactly, for all ten archs at full width: ``DecoderLM``/``EncDecModel``
``param_specs()`` (and their shapes), ``decode_state_spec_tree()``,
``input_specs`` and ``input_logical_specs`` for every arch x applicable
shape cell (32), ``opt_state_specs`` for float32 and int8 moments, and
``launch.modelflops``' ``param_counts`` and ``model_flops`` for every
cell. The JAX side uses ``jax.eval_shape`` (no memory is allocated)."""
import pytest

pytest.importorskip("torch")

from repro.configs import applicable_shapes as japplicable  # noqa: E402
from repro.configs import get_config as jconfig  # noqa: E402
from repro.launch.modelflops import model_flops as jmodel_flops  # noqa: E402
from repro.launch.modelflops import param_counts as jparam_counts  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.optimizer import opt_state_specs as jopt_specs  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    SHAPES,
    applicable_shapes,
    get_config,
    list_archs,
)
from repro_torch.launch.modelflops import model_flops, param_counts  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.optimizer import OptConfig, opt_state_specs  # noqa: E402

ARCHS = list_archs()
CELLS = [(a, s.name) for a in ARCHS for s in applicable_shapes(get_config(a))]


def _models(arch):
    return build_model(get_config(arch), device="cpu"), \
        jbuild(jconfig(arch))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def test_every_cell_is_listed():
    assert len(CELLS) == 32
    assert CELLS == [(a, s.name) for a in ARCHS
                     for s in japplicable(jconfig(a))]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_decode_state_specs_equal_the_reference(arch):
    port, ref = _models(arch)
    assert port.param_specs() == ref.param_specs()
    assert _shapes(port.param_shapes()) == _shapes(ref.param_shapes())
    assert port.decode_state_spec_tree() == ref.decode_state_spec_tree()


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_equal_the_reference(arch, shape):
    port, ref = _models(arch)
    from repro.configs.base import SHAPES as JSHAPES
    got, want = port.input_specs(SHAPES[shape]), \
        ref.input_specs(JSHAPES[shape])
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)
    assert port.input_logical_specs(SHAPES[shape]) == \
        ref.input_logical_specs(JSHAPES[shape])
    # model FLOPs and parameter counts: the same arithmetic, exactly
    pshapes = port.param_shapes()
    rshapes = ref.param_shapes()
    assert param_counts(port.cfg, pshapes) == \
        jparam_counts(ref.cfg, rshapes)
    assert model_flops(port.cfg, SHAPES[shape], pshapes) == \
        jmodel_flops(ref.cfg, JSHAPES[shape], rshapes)


@pytest.mark.parametrize("moments", ["float32", "int8"])
@pytest.mark.parametrize("arch", ["smollm-360m", "kimi-k2-1t-a32b",
                                  "whisper-base", "xlstm-350m"])
def test_opt_state_specs_equal_the_reference(arch, moments):
    port, ref = _models(arch)
    got = opt_state_specs(port.param_specs(), OptConfig(moments=moments))
    want = jopt_specs(ref.param_specs(), JOptConfig(moments=moments))
    assert got == want


def test_smollm_train_model_flops():
    """SmolLM-360M at phase 9's 8 x 512 tokens: 6 x 314,635,200 active
    parameters x 4096 tokens."""
    from repro_torch.configs.base import ShapeConfig
    port, _ = _models("smollm-360m")
    shape = ShapeConfig("train_8x512", 512, 8, "train")
    assert param_counts(port.cfg, port.param_shapes())["active"] == \
        314_635_200
    assert model_flops(port.cfg, shape, port.param_shapes()) == \
        7.732474675200e12
