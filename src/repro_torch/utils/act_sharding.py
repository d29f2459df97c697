"""Mesh context for activation-sharding constraints inside the model:
the port of ``repro/utils/act_sharding.py``, and ``placements``, the
DTensor placements of a ``PartitionSpec``'s entries (which
``launch/sharding.py`` gives every rule's result).

The step factories enter ``use_mesh(mesh)`` while they run; ``constrain``
is a no-op outside the context.  Inside it, an entry naming an axis
absent from the mesh, or a dim that the axes' size does not divide (or
that is smaller than it), collapses to ``None``, as JAX's does, and a
DTensor is redistributed to the resulting placements.
"""
from __future__ import annotations

import contextlib
import contextvars

from torch.distributed.tensor import DTensor, Replicate, Shard

_MESH = contextvars.ContextVar("repro_torch_act_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)


def current_mesh():
    return _MESH.get()


def placements(mesh, spec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: an entry naming
    one or more mesh axes (in the mesh's major-to-minor order) shards its
    tensor dim on each of those mesh dims."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"entry {entry} is not in the mesh's major-to-"
                             f"minor order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def collapse(mesh, spec_entries, shape) -> tuple:
    """JAX's rule: each entry (an axis name, a tuple of them, or None)
    kept where every axis is in ``mesh`` and their size divides the dim
    and is no larger than it, else None."""
    names = set(mesh.mesh_dim_names)

    def ok(entry, dim):
        if entry is None:
            return None
        axes = entry if isinstance(entry, tuple) else (entry,)
        if not all(a in names for a in axes):
            return None
        size = 1
        for a in axes:
            size *= mesh.shape[mesh.mesh_dim_names.index(a)]
        return entry if dim % size == 0 and dim >= size else None

    return tuple(ok(e, d) for e, d in zip(spec_entries, shape))


def constrain(x, spec_entries):
    """spec_entries: one axis name / tuple / None per dim of ``x``."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    spec = collapse(mesh, spec_entries, x.shape)
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(mesh, spec))
