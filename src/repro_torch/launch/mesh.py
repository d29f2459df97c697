"""Device meshes and the process group under them: the port of
``repro/launch/mesh.py``.

JAX's GSPMD mesh becomes a ``torch.distributed`` ``DeviceMesh`` with the
same shape and axis names.  A ``DeviceMesh`` needs a process group of
its size, which ``bring_up`` starts (a function, never at import: the
tests import every module of the port in one interpreter):
- ``"nccl"``: one rank on the card (``chip_smoke.py``'s mesh paths);
- ``"gloo"``: one or more ranks on the CPU (the tests);
- ``"fake"``: 256 or 512 ranks in one process, none of which exists
  (``torch.testing``'s fake backend), for the dry run, where this
  process plays rank 0 and a collective only gives its result's shape.
The rendezvous is a ``HashStore`` (one rank, or the fake backend's own
store) or a ``FileStore`` (several ranks), so no port is opened.
``AbstractMesh`` is a mesh's shape and names without devices, enough to
compute sharding rules (``launch/sharding.py``).
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

#: the mesh's device type under each backend (the fake one's is the
#: card's, so DTensor issues the card's collectives, all-to-all included)
DEVICE_TYPES = {"nccl": "cuda", "gloo": "cpu", "fake": "cuda"}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's ``shape`` and ``mesh_dim_names``, as ``DeviceMesh`` names
    them, without devices or a process group."""
    shape: tuple
    mesh_dim_names: tuple


def bring_up(backend: str, world_size: int = 1, rank: int = 0,
             store_path: str | None = None) -> None:
    """Start the default process group: ``backend`` one of
    ``DEVICE_TYPES``; a ``FileStore`` at ``store_path`` for gloo with
    more than one rank."""
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    elif world_size == 1:
        store = dist.HashStore()
    elif store_path is None:
        raise ValueError(f"{world_size} ranks need a store_path")
    else:
        store = dist.FileStore(store_path, world_size)
    if backend not in DEVICE_TYPES:
        raise ValueError(f"unknown backend {backend!r}; known: "
                         f"{sorted(DEVICE_TYPES)}")
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)


def tear_down() -> None:
    """Destroy the default process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape, axes, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process
    group that is up (its size the product of ``shape``); the device
    type is its backend's (``DEVICE_TYPES``) unless given."""
    if device_type is None:
        device_type = DEVICE_TYPES[dist.get_backend()]
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def dp_axes(mesh) -> tuple:
    """Data-parallel axes = every axis that isn't 'model'."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def axis_size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.shape[names.index(name)] if name in names else 1
