"""GF(256) matrix product (field polynomial 0x11D): the CUDA kernel
(``csrc/gf256.cu``) and its plain PyTorch version, behind one tensor
contract and two host hooks.

Tensor contract (``gf_matmul``): ``matrix`` uint8 (r, k) and ``data``
uint8 (k, L) on one device -> uint8 (r, L), byte-identical to
``core.erasure.gf_matmul``. A CUDA ``data`` launches the kernel; a CPU
one runs the plain version. The matrix is a runtime argument, so one
build serves every erasure signature.

Host hooks, with the contracts of ``repro.kernels.gf256.ops``:
``rs_matmul_fn(device)`` is ``ErasureCoder(matmul_fn=)``, numpy (r, k)
matrix and (k, L) stripes -> (r, L), used by the batched
``decode_many``; ``rs_parity_fn(rows, device)`` binds the parity rows of
an encode matrix, (k, L) -> (r, L).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.core import erasure
from repro_torch.kernels.parity.ops import to_tensor


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple:
    """(exp (512,) uint8, log (256,) int64) of the field on `device`."""
    return (torch.from_numpy(erasure._EXP.copy()).to(device),
            torch.from_numpy(erasure._LOG.astype(np.int64)).to(device))


def gf_matmul_plain(matrix: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same contract. Each
    product is exp[log a + log b] (both logs below 255, so no modulo
    with the 512-entry exp table), zero where either factor is zero."""
    exp, log = _tables(data.device)
    r, k = matrix.shape
    out = torch.zeros((r, data.shape[1]), dtype=torch.uint8,
                      device=data.device)
    logd = log[data.long()]
    nonzero = data != 0
    logm = log[matrix.long()]
    for i in range(r):
        for j in range(k):
            prod = exp[logd[j] + logm[i, j]]
            out[i] ^= torch.where(nonzero[j] & (matrix[i, j] != 0), prod, 0)
    return out


def gf_matmul(matrix: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """`matrix` x `data` over GF(256) (module doc): the CUDA kernel for a
    CUDA `data`, the plain version for a CPU one."""
    dev = data.device
    kernels.check_tensor(matrix, "matrix", torch.uint8, dev, 2)
    kernels.check_tensor(data, "data", torch.uint8, dev, 2)
    r, k = matrix.shape
    if data.shape[0] != k or r < 1 or k < 1:
        raise ValueError(f"matrix {tuple(matrix.shape)} does not take data "
                         f"{tuple(data.shape)}")
    if dev.type == "cpu":
        return gf_matmul_plain(matrix, data)
    if dev.type != "cuda":
        raise ValueError(f"gf_matmul runs on cuda or cpu, not {dev}")
    n = data.shape[1]
    out = torch.empty((r, n), dtype=torch.uint8, device=dev)
    if n:
        kernels.launch("gf256", "gf256", matrix.data_ptr(), r, k,
                       data.data_ptr(), n, out.data_ptr())
    return out


def rs_matmul_fn(device="cuda"):
    """``ErasureCoder(matmul_fn=...)`` hook on `device` (module doc)."""
    dev = resolve_device(device)

    def fn(matrix: np.ndarray, data_u8: np.ndarray) -> np.ndarray:
        return gf_matmul(to_tensor(matrix, dev),
                         to_tensor(data_u8, dev)).cpu().numpy()
    return fn


def rs_parity_fn(matrix_parity_rows: np.ndarray, device="cuda"):
    """(k, L) uint8 data -> (r, L) parity through ``gf_matmul``, with the
    bottom (n-k) rows of ``erasure.encode_matrix`` bound up front."""
    matmul = rs_matmul_fn(device)

    def fn(data_u8: np.ndarray) -> np.ndarray:
        return matmul(matrix_parity_rows, data_u8)
    return fn
