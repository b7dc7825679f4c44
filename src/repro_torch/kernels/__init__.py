"""Hand-written CUDA kernels of the port: build, load, launch counts.

Every ``csrc/*.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). The build happens at first use, one ``nvcc``
process per source, all started together, into ``build/`` at the root
of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it). A library is
named by the hash of its source and of the local headers that source
includes, so an edited source or header rebuilds just the libraries that
use it.

Each kernel's wrapper (``kernels.<name>.ops``) adds one to
``LAUNCHES[<kernel>]`` right after it launches the kernel, and nowhere
else, so a run can show which kernels its main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("sha256", "aes", "fused", "parity", "gf256")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"fused_verify_decrypt": 0, "sha256_many": 0,
            "aes_encrypt_many": 0, "parity": 0, "gf256": 0}
BUILD_INFO: dict = {}

_LOCK = threading.Lock()
_LIBS: dict = {}

_P = ctypes.c_void_p
_SIGNATURES = {
    "sha256": ("sha256_lanes_launch", [_P, _P, _P, ctypes.c_int, _P, _P]),
    "aes": ("aes_encrypt_launch",
            [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P, _P]),
    "fused": ("fused_verify_decrypt_launch",
              [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P]),
    "parity": ("parity_launch",
               [_P, ctypes.c_int, ctypes.c_longlong, _P, _P]),
    "gf256": ("gf256_matmul_launch",
              [_P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_longlong, _P, _P]),
}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def _sources_of(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes with
    ``#include "..."``, transitively, in a fixed order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        todo += [CSRC / h for h in _INCLUDE.findall(p.read_text())
                 if (CSRC / h).is_file()]
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in _sources_of(name):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every source that has no current library, one ``nvcc``
    per source, all in parallel. Returns BUILD_INFO: per source the
    library path, the seconds the build took (0 when it was already
    built) and ``nvcc``'s register/shared-memory report."""
    with _LOCK:
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in SOURCES:
            lib = _lib_path(name)
            if lib.exists():
                BUILD_INFO.setdefault(name, {"lib": str(lib), "seconds": 0.0,
                                             "ptxas": ""})
                continue
            tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        errors = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {name}.cu failed:\n{log}")
                continue
            os.replace(tmp, lib)
            BUILD_INFO[name] = {"lib": str(lib), "ptxas": log,
                                "seconds": time.perf_counter() - t0}
        if errors:
            raise RuntimeError("\n".join(errors))
        return BUILD_INFO


def library(name: str):
    """The loaded ctypes library of ``csrc/<name>.cu`` (built on first
    use), with its launch function's argument types set."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(BUILD_INFO[name]["lib"])
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def launch(name: str, kernel: str, *args) -> None:
    """Call ``csrc/<name>.cu``'s launch function on PyTorch's current
    stream, raise on a non-zero ``cudaGetLastError()``, and count the
    launch under ``LAUNCHES[kernel]``."""
    import torch
    lib = library(name)
    fn = getattr(lib, _SIGNATURES[name][0])
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    with _LOCK:
        LAUNCHES[kernel] += 1


def geometry(name: str, fn_name: str, n: int, keys: tuple) -> dict:
    """The launch geometry that ``csrc/<name>.cu``'s ``fn_name(n,
    long long *out)`` reports for `n` messages, as a dict over `keys`
    (built on first use)."""
    lib = library(name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(keys))()
    err = fn(n, out)
    if err != 0:
        raise RuntimeError(f"{fn_name}({n}) failed: error {err}")
    return dict(zip(keys, out))


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def check_tensor(t, name: str, dtype, device, ndim: int | None = None):
    """Raise unless `t` is a contiguous tensor of `dtype` on `device`."""
    import torch
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
