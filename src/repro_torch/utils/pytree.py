"""Tensor dataclass helpers — the port's stand-in for ``pytree_dataclass``.

``tensor_dataclass`` makes a frozen dataclass whose fields are tensors
(or nested tensor dataclasses); fields named in ``meta`` are static
identity data that every helper below passes through untouched.  Every
instance gets ``replace(**kw)`` and ``to(device)``.

``treedef`` keys a tree's structure as ``jax.tree_util.tree_structure``
does (class and meta values), so ``experiment.sweep`` groups policies
as the JAX package does; ``from_treedef`` rebuilds a tree from its key
and its leaves (``leaves`` order).  Tuples of tensors or of tensor
dataclasses are trees too (the union fabric's slot states and member
knobs).

Lane helpers: sweep lanes are an explicit leading ``[B, ...]`` axis on
every leaf (the JAX package puts them under ``vmap``).  ``lane_specs``
broadcasts one spec to B identical lanes, ``stack_specs`` stacks
same-family specs leaf-wise, ``take_lanes`` gathers lanes, and ``bwhere``
selects per lane.

Nested parameter trees (dicts, tuples, plain dataclasses such as the
AdamW state): ``flatten_with_path``, ``leaves``, ``unflatten`` and
``map_leaves`` walk them in ``jax.tree_util``'s order (dict keys sorted),
which the optimizer's sums and the checkpoint keys follow.
"""
from __future__ import annotations

import dataclasses

import torch


def _replace(self, **kw):
    return dataclasses.replace(self, **kw)


def _to(self, device):
    return tree_map(lambda x: x.to(device), self)


def tensor_dataclass(cls=None, *, meta: tuple = ()):
    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        c._meta_fields = tuple(meta)
        c.replace = _replace
        c.to = _to
        return c

    return wrap(cls) if cls is not None else wrap


def _data_fields(obj):
    meta = getattr(type(obj), "_meta_fields", ())
    return [f.name for f in dataclasses.fields(obj) if f.name not in meta]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over tensor dataclasses (meta fields kept
    from ``tree``); tensors are leaves, nested dataclasses and tuples
    recurse."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, x, *[r[i] for r in rest])
                     for i, x in enumerate(tree))
    if dataclasses.is_dataclass(tree) and hasattr(type(tree), "_meta_fields"):
        return dataclasses.replace(tree, **{
            nm: tree_map(fn, getattr(tree, nm), *[getattr(r, nm) for r in rest])
            for nm in _data_fields(tree)})
    raise TypeError(f"not a tensor dataclass leaf: {type(tree).__name__}")


def treedef(tree):
    """Hashable structure key of a tensor dataclass: equal for two trees
    exactly when ``jax.tree_util.tree_structure`` is equal for their JAX
    counterparts.  It holds the class, every meta field's value (e.g.
    ``migration_limit``, which sets plan widths) and, recursively, the
    same of each nested tensor dataclass; tensors are leaves, whatever
    their shape."""
    if isinstance(tree, torch.Tensor):
        return "*"
    if isinstance(tree, tuple):
        return (tuple, tuple(treedef(x) for x in tree))
    cls = type(tree)
    if dataclasses.is_dataclass(tree) and hasattr(cls, "_meta_fields"):
        return (cls, tuple((nm, getattr(tree, nm)) for nm in cls._meta_fields),
                tuple((nm, treedef(getattr(tree, nm)))
                      for nm in _data_fields(tree)))
    raise TypeError(f"not a tensor dataclass leaf: {cls.__name__}")


def from_treedef(td, new_leaves):
    """The tree whose ``treedef`` is ``td``, with ``new_leaves`` (in
    ``leaves`` order) as its tensors."""
    it = iter(new_leaves)

    def build(d):
        if d == "*":
            return next(it)
        if d[0] is tuple:
            return tuple(build(x) for x in d[1])
        cls, meta, data = d
        return cls(**{nm: build(sub) for nm, sub in data}, **dict(meta))

    return build(td)


def lane_specs(spec, B: int):
    """Broadcast one spec's leaves to B identical sweep lanes."""
    return tree_map(lambda x: x.unsqueeze(0).expand((B,) + x.shape)
                    .contiguous(), spec)


def stack_specs(specs):
    """Stack same-family specs leaf-wise into one lane-batched spec."""
    specs = list(specs)
    return tree_map(lambda *xs: torch.stack(xs), specs[0], *specs[1:])


def take_lanes(tree, idx):
    """Gather lanes of a lane-batched tree along axis 0."""
    return tree_map(lambda x: x.index_select(0, idx), tree)


def bwhere(pred, a, b):
    """Per-lane select: ``pred`` bool [B], leaves [B] or [B, ...]."""
    return tree_map(
        lambda x, y: torch.where(pred.reshape((-1,) + (1,) * (x.dim() - 1)),
                                 x, y), a, b)


def scatter_drop(x, idx, val, valid):
    """Per-lane ``x[b, idx[b, i]] = val`` where ``valid[b, i]``: the port
    of ``x.at[jnp.where(valid, idx, n)].set(val, mode="drop")``.

    torch has no dropping scatter, so the rows are copied once into a
    flat buffer with one scratch element past the end, invalid entries
    are sent there, and the result is a contiguous view of the rows.
    Valid indices of one lane are unique (the padded-index contract), so
    the write order of a parallel scatter never matters.  ``val`` is a
    tensor shaped like ``idx`` or a Python scalar.  ``x`` is not changed.
    """
    B, n = x.shape
    flat = x.new_empty((B * n + 1,))
    flat[:B * n].copy_(x.reshape(-1))
    lane = torch.arange(0, B * n, n, device=x.device).unsqueeze(1)
    at = torch.where(valid, idx + lane, B * n).reshape(-1)
    if isinstance(val, torch.Tensor):
        flat.scatter_(0, at, val.to(x.dtype).reshape(-1))
    else:
        flat.index_fill_(0, at, val)
    return flat[:B * n].view(B, n)


# ------------------------------------------------- nested parameter trees
def flatten_with_path(tree, path: tuple = ()) -> list:
    """``[(path, leaf)]`` in ``jax.tree_util``'s order: tuple and list
    items in order (path entry ``"[i]"``), dict items by sorted key, a
    dataclass's data fields in declaration order (entry: the field name);
    anything else is a leaf.  The port's parameter dicts, AdamW state and
    checkpoint trees are walked with it, so sums over leaves (the global
    grad norm) and checkpoint keys follow the JAX package."""
    if isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", x) for i, x in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(nm, getattr(tree, nm)) for nm in _data_fields(tree)]
    else:
        return [(path, tree)]
    out = []
    for key, sub in items:
        out += flatten_with_path(sub, path + (key,))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves):
    """``like``'s structure with its leaves replaced by ``new_leaves``, in
    ``flatten_with_path`` order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(
                t, **{nm: build(getattr(t, nm)) for nm in _data_fields(t)})
        return next(it)

    return build(like)


def map_leaves(fn, tree, *rest):
    """``fn`` applied leaf-wise over trees of one structure."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves(r) for r in rest))])
