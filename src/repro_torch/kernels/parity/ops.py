"""XOR parity of k erasure stripes: the CUDA kernel (``csrc/parity.cu``)
and its plain PyTorch version, behind one tensor contract and one host
hook.

Tensor contract (``parity``): ``data`` uint8 (k, L) -> uint8 (L,), the
XOR of the k rows. A CUDA ``data`` launches the kernel; a CPU one runs
the plain version. There is no fallback between the two.

Host hook (``parity_fn_for_erasure``): the ``ErasureCoder(parity_fn=)``
contract of ``repro.kernels.parity.ops``, numpy (k, L) uint8 -> (L,)
uint8. The L2 calls it once per ``put_chunk``, from the origin stage's
fetch threads at the same time; each call copies in, launches and copies
out on the calling thread's current stream, and the copy out waits for
the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import kernels, resolve_device


def parity_plain(data: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same contract."""
    out = data[0].clone()
    for j in range(1, data.shape[0]):
        torch.bitwise_xor(out, data[j], out=out)
    return out


def parity(data: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of `data` (module doc): the CUDA kernel for a CUDA
    `data`, the plain version for a CPU one."""
    dev = data.device
    kernels.check_tensor(data, "data", torch.uint8, dev, 2)
    if data.shape[0] < 1:
        raise ValueError("parity needs at least one stripe")
    if dev.type == "cpu":
        return parity_plain(data)
    if dev.type != "cuda":
        raise ValueError(f"parity runs on cuda or cpu, not {dev}")
    k, n = data.shape
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    if n:
        kernels.launch("parity", "parity", data.data_ptr(), k, n,
                       out.data_ptr())
    return out


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A uint8 numpy array as a contiguous tensor on `device` (read-only
    arrays, such as ``np.frombuffer`` views, are copied first)."""
    a = np.ascontiguousarray(a, np.uint8)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def parity_fn_for_erasure(device="cuda"):
    """``ErasureCoder(parity_fn=...)`` hook on `device` (module doc)."""
    dev = resolve_device(device)

    def fn(data_u8: np.ndarray) -> np.ndarray:
        return parity(to_tensor(data_u8, dev)).cpu().numpy()
    return fn
