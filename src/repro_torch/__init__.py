"""PyTorch/CUDA port of the on-demand container-loading system.

A second package beside the JAX one (``repro``): it imports ``torch``
and numpy and never ``jax`` or anything of ``repro``. Its entry points
take ``device=`` and default to ``"cuda"``; without a GPU they raise
unless the caller asks for ``device="cpu"``, where every kernel wrapper
runs its plain PyTorch version."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a ``torch.device``; raises for a CUDA device on a
    machine without one (there is no quiet CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
