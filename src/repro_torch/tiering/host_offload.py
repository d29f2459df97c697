"""Slow-tier realization modes: the port of ``repro/tiering/host_offload.py``.

``memkind`` places a slow pool's buffer in pinned host memory, which the
card reads and writes over the host link (the default ``hbm-pcie``
machine's slow tier); the ``migrate`` kernel takes such a home pool as
it is.  ``buffer`` keeps the buffer where it is (the same data plane).
Where no CUDA device is present, ``memkind`` keeps the data where it is,
as the reference does where the memory kind is missing; on a card a pin
that fails raises.  ``mesh`` is ``None``, a device count, or a mesh: one
device works the same as ``None``.  On a ``DeviceMesh`` of more devices
``memkind`` returns the tensor replicated over the mesh (a DTensor whose
every placement is ``Replicate``), its local copy pinned on the host
(``to_slow_tier``) or on the card (``to_fast_tier``), where JAX puts it
with ``NamedSharding(mesh, P(), memory_kind=...)``; a count of more than
one device names no devices and raises.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate

MODES = ("buffer", "memkind")


def supports_memkind() -> bool:
    """Is there pinned host memory for the slow tier: a CUDA device?"""
    return torch.cuda.is_available()


def _mesh_size(mesh) -> int:
    if mesh is None:
        return 1
    if isinstance(mesh, DeviceMesh):
        return mesh.size()
    return int(getattr(mesh, "size", mesh))


def _check(mode: str, mesh) -> DeviceMesh | None:
    """The mesh to replicate over (None: one device)."""
    if mode not in MODES:
        raise ValueError(f"unknown slow-tier mode {mode!r}; known: {MODES}")
    if _mesh_size(mesh) == 1:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"a mesh of {_mesh_size(mesh)} devices: pass its "
                         "DeviceMesh to replicate over it")
    return mesh


def _replicated(x: torch.Tensor, mesh):
    if mesh is None:
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def to_slow_tier(x: torch.Tensor, mode: str = "buffer", mesh=None):
    """Place a tensor in the slow tier: under ``memkind`` with a card, a
    pinned host copy of ``x`` (``x`` itself if it is pinned already),
    replicated over a mesh of more than one device."""
    mesh = _check(mode, mesh)
    if mode == "buffer":
        return x
    x = _local(x)
    if not supports_memkind() or (x.device.type == "cpu"
                                  and x.is_pinned()):
        return _replicated(x, mesh)
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    if not out.is_pinned():
        raise RuntimeError("to_slow_tier: the host copy is not pinned")
    return _replicated(out, mesh)


def to_fast_tier(x: torch.Tensor, mode: str = "buffer", mesh=None):
    """Place a tensor in the fast tier: under ``memkind`` with a card, on
    the card (``x`` itself if it is there already), replicated over a
    mesh of more than one device."""
    mesh = _check(mode, mesh)
    if mode == "buffer":
        return x
    x = _local(x)
    return _replicated(x.to("cuda") if supports_memkind() else x, mesh)
