"""Production mesh builders (the port of ``repro.launch.mesh``):
functions, never module-level constants, so importing this module
touches no process group.

Both build a ``torch.distributed`` ``DeviceMesh`` over the default
process group, whose world size must equal the mesh's: an NCCL or gloo
group of that many ranks, or, for a dry run in one process, the fake
backend (``launch.dryrun.init_fake_world``). The device type defaults
to ``"cuda"`` and goes through ``repro_torch.resolve_device``: without
a card it raises unless the caller passes ``device_type="cpu"``."""
from __future__ import annotations

from repro_torch import resolve_device


def _mesh(shape: tuple, axes: tuple, device_type):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device_type).type
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           f"ranks (have {have})")
    return init_device_mesh(dev, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A (data, model) mesh over the current process group — used by
    tests and by one card's world-1 group."""
    return _mesh((data, model), ("data", "model"), device_type)
