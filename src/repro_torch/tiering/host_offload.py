"""Slow-tier realization modes: the port of ``repro/tiering/host_offload.py``.

``memkind`` places a slow pool's buffer in pinned host memory, which the
card reads and writes over the host link (the default ``hbm-pcie``
machine's slow tier); the ``migrate`` kernel takes such a home pool as
it is.  ``buffer`` keeps the buffer where it is (the same data plane).
Where no CUDA device is present, ``memkind`` returns its input, as the
reference does where the memory kind is missing; on a card a pin that
fails raises.  ``mesh`` is ``None``, a device count, or an object with a
``size`` (a mesh of that many devices): one device works the same as
``None``, more raise, since sharding a pool over devices belongs to the
JAX-specific launch layer.
"""
from __future__ import annotations

import torch

MODES = ("buffer", "memkind")


def supports_memkind() -> bool:
    """Is there pinned host memory for the slow tier: a CUDA device?"""
    return torch.cuda.is_available()


def _check(mode: str, mesh) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown slow-tier mode {mode!r}; known: {MODES}")
    size = 1 if mesh is None else int(getattr(mesh, "size", mesh))
    if size != 1:
        raise NotImplementedError(
            f"a mesh of {size} devices: placing a pool over a mesh is the "
            "JAX-specific launch layer's, which the port does not have")


def to_slow_tier(x: torch.Tensor, mode: str = "buffer", mesh=None):
    """Place a tensor in the slow tier: under ``memkind`` with a card, a
    pinned host copy of ``x`` (``x`` itself if it is pinned already)."""
    _check(mode, mesh)
    if mode == "buffer" or not supports_memkind():
        return x
    if x.device.type == "cpu" and x.is_pinned():
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    if not out.is_pinned():
        raise RuntimeError("to_slow_tier: the host copy is not pinned")
    return out


def to_fast_tier(x: torch.Tensor, mode: str = "buffer", mesh=None):
    """Place a tensor in the fast tier: under ``memkind`` with a card, on
    the card (``x`` itself if it is there already)."""
    _check(mode, mesh)
    if mode == "buffer" or not supports_memkind():
        return x
    return x.to("cuda")
