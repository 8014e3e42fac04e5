"""Process meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``): a ``DeviceMesh`` names the dims, ``("data",
"model")`` by default, and builds one process group per dim.

The backend follows the device: NCCL serves ``cuda`` and gloo serves
``cpu``.  A caller that wants another pairing (gloo over CUDA tensors, to
run several ranks on one card) names it with ``backend=``; nothing here
picks one by itself.  When no default process group exists, the first
mesh initialises one from the environment ``torchrun`` sets (``env://``);
a caller outside ``torchrun`` calls ``init_process_group`` first.

``make_sp2d_mesh`` factors the SP dim into a 2D process grid
``("sp_out", "sp_in")`` for the USP hybrid (``core.ulysses.usp_attention``).

``elastic_submesh`` is the elastic resize's survivor mesh, shared by
``Trainer.replan`` and ``ServingEngine.replan``.  ``resolve_topology``
prices a plan on ``uniform`` links (the byte model) or on a measured
fabric (``profile:<path>``, ``Topology.from_profile``); the JAX package's
TPU link presets are not ported (ROADMAP, standing notes).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def close_world() -> None:
    """Leave the default process group, if any, once every rank got here:
    one barrier, then ``destroy_process_group``.  A gloo group left to the
    interpreter's exit is torn down while a peer's threads may still talk
    to it, and the process aborts ("terminate called without an active
    exception") after its work is done.  The CLIs call it after their
    work under ``torchrun``."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


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


def make_sp2d_mesh(outer: int, inner: int, dp: int = 1,
                   dp_axis: str = "data", device_type: str = "cuda", *,
                   backend: Optional[str] = None) -> DeviceMesh:
    """A mesh whose SP dim is factored into a 2D process grid ``(sp_out =
    outer, sp_in = inner)``, ``sp_out`` major, so that each ``sp_out``
    slice holds a contiguous block of the sequence (one host's group of
    cards in JAX's ICI x DCN reading).  A hybrid stage rings K/V over
    ``sp_out`` while it all-to-alls inside ``sp_in``.  ``dp > 1``
    prepends a data dim."""
    if dp > 1:
        return make_mesh((dp, outer, inner), (dp_axis, "sp_out", "sp_in"),
                         device_type, backend=backend)
    return make_mesh((outer, inner), ("sp_out", "sp_in"), device_type,
                     backend=backend)


def elastic_submesh(n_devices: int, *, data: int, held: int, active: bool,
                    device_type: str,
                    regrow: str) -> Tuple[Optional[DeviceMesh], bool]:
    """The survivor mesh of an elastic resize onto the first ``n_devices``
    ranks of the world, and whether this rank leaves it: ``submesh`` with
    ``data`` kept where it divides ``n_devices`` (else 1), its
    ``("data", "model")`` group made now by every rank, as ``new_group``
    requires; None at one device (the caller drops its mesh).  ``held``
    is how many ranks hold state now, ``active`` whether this one does:
    growing onto ranks that left raises ``NotImplementedError`` naming
    ``regrow``, what to do instead.  Every rank of the world calls it."""
    from repro_torch.core.layout import _flat_group
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices > world:
        raise ValueError(f"replan({n_devices}) exceeds the {world} "
                         f"available devices")
    if not active or n_devices > held:
        raise NotImplementedError(
            f"replan({n_devices}) onto ranks that hold no state (the mesh "
            f"holds {held}): {regrow}")
    leaving = (dist.get_rank() if dist.is_initialized() else 0) >= n_devices
    if n_devices == 1:
        return None, leaving
    mesh = submesh(n_devices, data if n_devices % data == 0 else 1,
                   device_type=device_type, backend=dist.get_backend())
    _flat_group(mesh, tuple(mesh.mesh_dim_names))
    return mesh, leaving


TOPOLOGY_PRESETS = ("uniform",)
# the JAX package's TPU link presets, which the port does not carry
TPU_PRESETS = ("ici", "torus", "ici_dcn")


def resolve_topology(kind: str, sp: int):
    """The ``Topology`` of an SP group of ``sp`` ranks that prices a plan:
    ``uniform`` (``Topology.uniform``: each transition costs its bytes) or
    ``profile:<path>``, a JSON file of ``[[global_bytes, seconds], ...]``
    all-gather samples fitted by ``Topology.from_profile``.  JAX's TPU
    presets raise ``ValueError`` naming the ROADMAP's standing note."""
    from repro_torch.core.topology import Topology
    if kind.startswith("profile:"):
        import json
        with open(kind[len("profile:"):]) as f:
            samples = [tuple(s) for s in json.load(f)]
        return Topology.from_profile(sp, samples)
    if kind == "uniform":
        return Topology.uniform(sp)
    if kind in TPU_PRESETS:
        raise ValueError(
            f"topology {kind!r} is a TPU link preset the port does not "
            f"carry (ROADMAP queue 1, standing notes): use uniform or "
            f"profile:<path> (Topology.from_profile over timed NCCL "
            f"all-gathers)")
    raise ValueError(f"unknown topology kind {kind!r} (want uniform or "
                     f"profile:<path>)")


def topology_meta(topo) -> dict:
    """The fabric facts a metrics JSON records for a ``Topology``: the
    per-link model the planner priced on."""
    if topo is None:
        return {"topology": None}
    return {
        "topology": [{"name": a.name, "size": a.size,
                      "bandwidth_gbps": a.bandwidth / 1e9,
                      "latency_s": a.latency} for a in topo.axes],
        "bottleneck_bandwidth_gbps": topo.bottleneck_bandwidth / 1e9,
    }
