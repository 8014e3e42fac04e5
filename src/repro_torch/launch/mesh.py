"""Process meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``): a ``DeviceMesh`` names the dims, ``("data",
"model")`` by default, and builds one process group per dim.

The backend follows the device: NCCL serves ``cuda`` and gloo serves
``cpu``.  A caller that wants another pairing (gloo over CUDA tensors, to
run several ranks on one card) names it with ``backend=``; nothing here
picks one by itself.  When no default process group exists, the first
mesh initialises one from the environment ``torchrun`` sets (``env://``);
a caller outside ``torchrun`` calls ``init_process_group`` first.

The JAX package's TPU meshes and their topologies are not ported; the
H100's fabric enters the planner through ``Topology.from_profile``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}


def _world(device_type: str, backend: Optional[str]) -> None:
    """Check the device and the backend, and make sure the default process
    group exists over ``backend`` (the device's own when None)."""
    if device_type not in BACKEND_OF:
        raise ValueError(f"device_type {device_type!r} not in "
                         f"{tuple(BACKEND_OF)}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu' "
                           "to build a gloo mesh on the CPU")
    backend = backend or BACKEND_OF[device_type]
    if not dist.is_initialized():
        dist.init_process_group(backend)
    elif dist.get_backend() != backend:
        raise ValueError(f"the default process group runs "
                         f"{dist.get_backend()}, the mesh asks for {backend}")


def make_mesh(shape: Sequence[int], axes: Sequence[str] = ("data", "model"),
              device_type: str = "cuda", *,
              backend: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` over every rank of the world, dims named
    ``axes``."""
    _world(device_type, backend)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def submesh(n_devices: int, data: int = 1, axis_names=("data", "model"),
            device_type: str = "cuda", *,
            backend: Optional[str] = None) -> DeviceMesh:
    """Mesh over the first ``n_devices`` ranks (the elastic-resize survivor
    set): (data, n_devices // data).  Every rank of the world calls it;
    ranks past ``n_devices`` hold no coordinate on it."""
    if n_devices % data:
        raise ValueError(f"{n_devices} devices not divisible by data={data}")
    _world(device_type, backend)
    ranks = torch.arange(n_devices).reshape(data, n_devices // data)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))
