"""The port's public surface against the JAX package's, read from the
source of both with ``ast`` (nothing is imported, so no jax runs): every
public top-level name of every module of ``repro`` and every public
method of its classes must have a counterpart of the same name in the
same module of ``repro_torch``, except the names listed here, each
with its reason. The list holds only the deliberate divergences of
ROADMAP.md §3, so the port cannot drop surface silently. The functions the
read path's Fig. 11 and the L2's Fig. 9 are built from must also keep
the reference's argument names and defaults."""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
# the JAX round's end-to-end examples: each needs a module of the same
# name in ``repro_torch.examples`` (``python -m repro_torch.examples.<name>``)
EXAMPLES = sorted(p.stem for p in
                  (SRC.parent / "examples").glob("*.py"))

# a reference module whose names the port keeps in another module
MERGED = {"configs/registry.py": "configs/__init__.py"}

# ROADMAP.md §3 "Jax-only routes": the jnp and Pallas kernel routes,
# their TPU layouts and XLA knobs; the port's routes are the CUDA
# kernels and their plain PyTorch versions
JAX_ROUTES = {
    "core/decode.py:enable_persistent_compilation_cache",
    "kernels/__init__.py:on_tpu",
    "kernels/aes/aesjax.py", "kernels/aes/bitslice.py",
    "kernels/aes/bitslice_pallas.py",
    "kernels/aes/ops.py:ctr_keystream_many_bitsliced",
    "kernels/aes/ops.py:ctr_keystream_many_jax",
    "kernels/aes/ops.py:encrypt_many_bitsliced",
    "kernels/aes/ops.py:encrypt_many_jax",
    "kernels/fused/fusedp.py",
    "kernels/gf256/gf256.py", "kernels/gf256/ref.py",
    "kernels/parity/parity.py", "kernels/parity/ref.py",
    "kernels/parity/ops.py:pack_stripes",
    "kernels/parity/ops.py:parity_int32",
    "kernels/sha256/sha256p.py",
    "kernels/sha256/ops.py:sha256_many_pallas",
    "launch/train.py:XLA_PERF_FLAGS",
    # the XLA HLO text parser and analyzer: the port counts a traced step
    # with a TorchDispatchMode (launch/roofline.py: StepCounter,
    # count_step, roofline_from_costs), and its collectives run at the
    # H100's NVLink or NIC rate, not a TPU's ICI_BW
    "launch/roofline.py:parse_hlo", "launch/roofline.py:analyze_hlo",
    "launch/roofline.py:analyze_computation",
    "launch/roofline.py:Computation", "launch/roofline.py:Instr",
    "launch/roofline.py:roofline_from_hlo", "launch/roofline.py:ICI_BW",
}
# ROADMAP.md §3 "Weights are drawn by one rule": the JAX package's
# per-module init functions split a jax.random key per name; the port
# draws every leaf by ``models.lm.init_rule`` (``init_flat``,
# ``init_device``), and its shapes come from ``param_specs(cfg)``
JAX_INIT = {
    "models/common.py:Params", "models/common.py:Specs",
    "models/common.py:stable_fold", "models/common.py:dense_init",
    "models/common.py:embed_init", "models/common.py:norm_init",
    "models/blocks.py:sublayer_init", "models/mamba.py:mamba_init",
    "models/mlp.py:mlp_init", "models/moe.py:moe_init",
    "models/xlstm.py:mlstm_init", "models/xlstm.py:slstm_init",
    "models/lm.py:DecoderLM.init", "models/encdec.py:EncDecModel.init",
}
# ROADMAP.md §3 "flash_vjp is one path": autograd through flash_attn
FLASH_VJP = {"models/attention.py:flash_attn_vjp",
             "models/attention.py:make_flash_vjp"}
EXCEPTIONS = JAX_ROUTES | JAX_INIT | FLASH_VJP

# (module, qualified name) that must keep the reference's arguments
SIGNATURES = [
    ("core/blockdev.py", "pipelined_latency"),
    ("core/blockdev.py", "TieredReader.__init__"),
    ("core/cache/distributed.py", "CacheNode.__init__"),
    ("core/cache/distributed.py", "DistributedCache.__init__"),
    ("core/cache/distributed.py", "DistributedCache.get_chunk_unreplicated"),
    ("core/cache/distributed.py", "DistributedCache.fail_node"),
    ("core/cache/distributed.py", "DistributedCache.flush"),
    ("core/cache/distributed.py", "DistributedCache.hit_rate"),
    ("core/cache/hashring.py", "HashRing.__init__"),
    ("core/cache/hashring.py", "HashRing.lookup"),
    ("core/cache/hashring.py", "HashRing.remove_node"),
    ("core/cache/hashring.py", "HashRing.record_placement"),
    ("core/cache/hashring.py", "HotKeyTracker.__init__"),
    ("core/cache/hashring.py", "HotKeyTracker.rate"),
    ("core/cache/local.py", "LocalCache.hit_rate"),
    ("core/cache/lru_k.py", "LRUK.keys"),
    ("core/crypto/convergent.py", "chunk_name"),
    ("core/crypto/sha256v.py", "sha256_many_np"),
    ("core/crypto/sha256v.py", "sha256_many"),
    ("core/manifest.py", "Manifest.unique_names"),
    ("core/gc.py", "RootPinRegistry.count"),
    ("core/decode.py", "registered_backends"),
    ("core/decode.py", "get_backend"),
    ("core/service.py", "ImageService.__init__"),
    ("core/publish.py", "PublishPipeline.copy_chunks"),
    ("core/publish.py", "image_id_for"),
    ("models/common.py", "count_params"),
    ("train/step.py", "make_prefill_step"),
    ("train/step.py", "make_decode_step"),
]


def _module(path: Path) -> tuple:
    """(top-level names, {class: {method or property}}, {qualname:
    FunctionDef}) of one source file. Imported names count as defined:
    a module may re-export what another defines."""
    tree = ast.parse(path.read_text())
    names, methods, funcs = set(), {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        if isinstance(node, ast.FunctionDef):
            funcs[node.name] = node
        elif isinstance(node, ast.ClassDef):
            methods[node.name] = set()
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    methods[node.name].add(item.name)
                    funcs[f"{node.name}.{item.name}"] = item
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names, methods, funcs


def _defined(path: Path) -> set:
    """The public names `path` defines itself (no imports)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def _port_path(rel: str) -> Path:
    return SRC / "repro_torch" / MERGED.get(rel, rel)


def _missing() -> list:
    out = []
    for ref in sorted((SRC / "repro").rglob("*.py")):
        rel = ref.relative_to(SRC / "repro").as_posix()
        port = _port_path(rel)
        if not port.exists():
            out.append(rel)
            continue
        pnames, pmethods, _ = _module(port)
        _, rmethods, _ = _module(ref)
        out += [f"{rel}:{n}" for n in sorted(_defined(ref))
                if n not in pnames]
        for cls, ms in rmethods.items():
            if cls.startswith("_") or cls not in pmethods:
                continue
            out += [f"{rel}:{cls}.{m}" for m in sorted(ms)
                    if not m.startswith("_") and m not in pmethods[cls]]
    return out


def test_every_reference_name_has_a_counterpart():
    missing = set(_missing())
    assert sorted(missing - EXCEPTIONS) == []


def test_every_exception_is_still_missing():
    """An exception the port has since filled must leave the list (and
    ROADMAP.md §3)."""
    assert sorted(EXCEPTIONS - set(_missing())) == []


def _args(fn: ast.FunctionDef) -> list:
    """(kind, name, default source) of every argument."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [("pos", x.arg, d and ast.unparse(d)) for x, d in zip(pos, defaults)]
    out += [("kw", x.arg, d and ast.unparse(d))
            for x, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.vararg:
        out.append(("*", a.vararg.arg, None))
    if a.kwarg:
        out.append(("**", a.kwarg.arg, None))
    return out


@pytest.mark.parametrize("rel,qualname", SIGNATURES,
                         ids=[f"{m}:{q}" for m, q in SIGNATURES])
def test_signature_matches_the_reference(rel, qualname):
    _, _, rfuncs = _module(SRC / "repro" / rel)
    _, _, pfuncs = _module(_port_path(rel))
    assert qualname in pfuncs, f"{rel}:{qualname} missing from the port"
    assert _args(pfuncs[qualname]) == _args(rfuncs[qualname])


def test_the_reference_ships_examples():
    assert EXAMPLES


@pytest.mark.parametrize("name", EXAMPLES)
def test_every_example_has_a_port_module(name):
    """``examples/<name>.py`` of the JAX round has a port module
    ``repro_torch/examples/<name>.py`` whose ``main(argv=None)`` is the
    entry point, run as ``python -m``, with ``--device`` defaulting to
    ``cuda``."""
    port = SRC / "repro_torch" / "examples" / f"{name}.py"
    assert port.exists(), f"examples/{name}.py has no port module"
    _, _, funcs = _module(port)
    assert "main" in funcs
    assert _args(funcs["main"])[0] == ("pos", "argv", "None")
    text = port.read_text()
    assert 'if __name__ == "__main__":' in text
    assert 'add_argument("--device", default="cuda"' in text
