"""Sharding rules: params (TP over 'model' + FSDP over 'data'), inputs
(DP over 'pod'x'data'), KV caches (batch over DP axes, sequence over
'model' when head counts don't tile it): the port of
``repro/launch/sharding.py``, rule for rule.

Rules are name-based (Megatron layout where the name identifies the role)
with a divisibility-checked generic fallback.  Each result is a
``Sharding``: the spec, one entry per tensor dim equal to JAX's
``PartitionSpec`` entry (an axis name, a tuple of them, or None), and the
DTensor placements it means on the mesh, one per mesh dim: an entry
naming several axes, such as ``("pod", "data")``, is ``Shard(d)`` on
each of those mesh dims, major to minor in the mesh's order, as JAX lays
out such a dim.  The rules read only the mesh's shape and names, so they
take an ``AbstractMesh`` as well as a ``DeviceMesh``; ``distribute_tree``
needs the latter.  Trees are the port's (dicts, tuples, dataclasses such
as the AdamW state and the caches), walked with ``utils.pytree``; a
leaf's path is its dict keys and dataclass field names.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.launch.mesh import axis_size, dp_axes
from repro_torch.utils.act_sharding import placements
from repro_torch.utils.pytree import flatten_with_path, leaves, unflatten

# param names whose FIRST matmul dim is the contracting/model dim
_ROW_PARALLEL = {"wo", "out_proj"}


class Sharding:
    """``spec``: JAX's ``PartitionSpec`` entries, one per tensor dim;
    ``placements``: the DTensor placements, one per mesh dim.  Not a
    dataclass, so the tree helpers take it as a leaf."""
    __slots__ = ("spec", "placements")

    def __init__(self, spec: tuple, placements: tuple):
        self.spec, self.placements = spec, placements

    def __eq__(self, other):
        return isinstance(other, Sharding) and \
            (self.spec, self.placements) == (other.spec, other.placements)

    def __repr__(self):
        return f"Sharding(spec={self.spec}, placements={self.placements})"


def _sharding(mesh, spec) -> Sharding:
    """A one-axis tuple entry is its axis name, as ``PartitionSpec``
    keeps it."""
    spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)
    return Sharding(spec, placements(mesh, spec))


def _divisible(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _leaf_spec(names, shape, mesh) -> tuple:
    msize = axis_size(mesh, "model")
    dsize = axis_size(mesh, "data")
    nd = len(shape)

    # embeddings: [V, D] vocab over model, d_model over data
    if "table" in names:
        lead = nd - 2
        v_ok = _divisible(shape[lead], msize)
        d_ok = _divisible(shape[lead + 1], dsize)
        return (None,) * lead + ("model" if v_ok else None,
                                 "data" if d_ok else None)

    if nd == 0 or nd == 1:
        return ()

    # stacked-layer leading axes (scan dims) stay unsharded
    lead = nd - 2
    a, b = shape[-2], shape[-1]

    # MoE expert stacks [*, E, D, F] / [*, E, F, D]: experts over model (EP)
    if nd >= 3 and names and names[-1] in ("wi", "wo") and "moe" in names:
        lead = nd - 3
        e = shape[lead]
        e_spec = "model" if _divisible(e, msize) else None
        a_spec = "data" if _divisible(a, dsize) else None
        return (None,) * lead + (e_spec, a_spec, None)

    row = any(n in _ROW_PARALLEL for n in names[-2:])
    if row:  # [contracting(model), out(data)]
        return (None,) * lead + ("model" if _divisible(a, msize) else None,
                                 "data" if _divisible(b, dsize) else None)
    return (None,) * lead + ("data" if _divisible(a, dsize) else None,
                             "model" if _divisible(b, msize) else None)


def _tree_map(fn, tree):
    """``fn(path, leaf)`` over the leaves (tensors, or anything with a
    ``shape``) of a tree, in the tree's structure."""
    if isinstance(tree, torch.Tensor):
        return fn((), tree)
    pairs = flatten_with_path(tree)
    return unflatten(tree, [fn(path, leaf) for path, leaf in pairs])


def param_shardings(params_shapes, mesh, serve: bool = False):
    """Tree of ``Sharding`` matching a params (or grads/opt-state) tree.

    ``serve=True`` drops the FSDP ('data') factor: at decode batch sizes,
    re-gathering weight shards every step costs more than the memory the
    sharding saves — weights stay TP('model')-sharded and replicated
    across data-parallel serving replicas."""
    def spec(path, leaf):
        p = _leaf_spec(list(path), tuple(leaf.shape), mesh)
        if serve:
            p = tuple(None if e == "data" else e for e in p)
        return _sharding(mesh, p)

    return _tree_map(spec, params_shapes)


def batch_sharding(mesh, batch_shapes):
    """Token batches: leading (global batch) dim over all DP axes."""
    dp = dp_axes(mesh)

    def spec(_path, leaf):
        nd = len(leaf.shape)
        b = leaf.shape[0] if nd else 1
        total = 1
        for a in dp:
            total *= axis_size(mesh, a)
        first = dp if nd and _divisible(b, total) else None
        return _sharding(mesh, (first,) + (None,) * (nd - 1))

    return _tree_map(spec, batch_shapes)


def cache_sharding(mesh, cache_shapes):
    """KV/state caches: batch dim over DP axes when divisible; the sequence
    dim over 'model' when divisible (flash-decoding style split); head dims
    over 'model' only when batch could not be sharded AND heads divide.

    Cache layouts handled: [L?, B, S, KV, dh] (KV), [L?, B, S, R] (MLA
    latent), [L?, B, K-1, C] / [L?, B, H, P, N] (mamba)."""
    dp = dp_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= axis_size(mesh, a)
    msize = axis_size(mesh, "model")

    def spec(_path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        entries = [None] * nd
        # batch dim: stacked cache layouts ([L, B, ...], ndim >= 4) carry
        # the batch at dim 1; unstacked ([B, ...]) at dim 0.  Never shard
        # the layer-stack dim.
        cand = 1 if nd >= 4 else 0
        b_at = cand if (_divisible(shape[cand], dp_total)
                        and shape[cand] >= dp_total) else None
        if b_at is not None:
            entries[b_at] = dp
        # sequence dim: the largest remaining dim divisible by model size
        s_at, s_val = None, 0
        for i in range(nd):
            if i == b_at:
                continue
            if _divisible(shape[i], msize) and shape[i] > s_val \
                    and shape[i] >= msize:
                s_at, s_val = i, shape[i]
        if s_at is not None:
            if b_at is None and _divisible(shape[s_at], dp_total * msize):
                # batch unshardable (e.g. long_500k B=1): context-parallel
                # split of the sequence over EVERY axis.
                entries[s_at] = dp + ("model",)
            else:
                entries[s_at] = "model"
        return _sharding(mesh, entries)

    return _tree_map(spec, cache_shapes)


def replicated(mesh) -> Sharding:
    return _sharding(mesh, ())


def distribute_tree(tree, shardings, mesh):
    """``tree`` (the port's params, optimizer state, batch or cache, on
    every rank alike) as DTensors on ``mesh``, each leaf placed as its
    ``Sharding`` in ``shardings`` (a tree of the same structure, or one
    ``Sharding`` for a single tensor) says; each rank keeps its own
    shard of its own copy, nothing is sent."""
    def put(t, sh):
        return distribute_tensor(t, mesh, list(sh.placements),
                                 src_data_rank=None)

    if isinstance(tree, torch.Tensor):
        return put(tree, shardings)
    return unflatten(tree, [put(t, sh) for t, sh in
                            zip(leaves(tree), leaves(shardings))])
