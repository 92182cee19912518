"""Mesh builders, the JAX package's ``launch/mesh.py`` on the port, over
``torch.distributed``'s ``DeviceMesh``.

Single pod: (16, 16) = 256 ranks over ("data", "model"); multi pod: (2,
16, 16) = 512 ranks over ("pod", "data", "model").  Each function builds
its mesh when called: importing this module touches no device and no
process group, and a caller may swap ``make_production_mesh`` for a
small mesh (the port's tests and ``chip_smoke.py`` do).  The process
group is the caller's (``torchrun`` style, or the fake one for a dry
run); :func:`make_host_mesh` starts a world of one if there is none.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _device_type() -> str:
    """``cuda`` under NCCL, ``cpu`` under any other backend (gloo, fake)."""
    import torch.distributed as dist

    return "cuda" if "nccl" in str(dist.get_backend()).lower() else "cpu"


def _build(shape: Sequence[int], axes: Sequence[str], device_type: Optional[str]):
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    device_type = device_type or _device_type()
    if math.prod(shape) == _world():
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} — "
            f"start {n} ranks (torchrun), or the fake process group for a dry run")
    return _build(shape, axes, device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: Optional[str] = None):
    """General mesh helper for tests / small meshes / elastic re-meshing:
    the first prod(shape) ranks of the process group."""
    n = math.prod(shape)
    have = _world()
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    return _build(shape, axes, device_type)


def start_single_process_group(device: str = "cuda") -> None:
    """A process group of one rank (NCCL for ``cuda``, gloo for ``cpu``)
    on an in-memory store, unless one is running."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if str(device).startswith("cuda") else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(device: str = "cuda"):
    """(1, 1) mesh over ("data", "model") on one device (``cuda`` unless the
    caller asks for ``cpu``); starts a process group of one rank if none
    is running."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    start_single_process_group(dev.type)
    if dev.type == "cuda":
        import torch

        torch.cuda.set_device(dev.index or 0)
    return _build((1, 1), ("data", "model"), dev.type)
