"""The gradient of a kernel's plain version, for the CPU kernel of its
backward custom op.

A custom op's kernel runs below autograd, and a DTensor's local op runs
below DTensor's dispatch, which leaves out every dispatch key after
Python (autograd and functorch among them), so neither ``autograd.grad``
nor ``torch.func.vjp`` works there as it stands.  ``vjp`` puts back the
dispatcher's thread-local key sets that hold outside any op (taken when
this module is imported) and differentiates the plain version by
autograd: the bits of autograd through it outside the op.
"""
from __future__ import annotations

import torch

_OUTSIDE = (torch._C._dispatch_tls_local_include_set(),
            torch._C._dispatch_tls_local_exclude_set())


def vjp(fn, primals, cotangents) -> tuple:
    """``d(outs . cotangents) / d primals`` of ``outs = fn(*primals)`` (a
    tuple), over the outputs whose cotangent is not None, each gradient
    contiguous as the kernels' are."""
    with torch._C._ForceDispatchKeyGuard(*_OUTSIDE), torch.enable_grad():
        primals = [t.detach().requires_grad_() for t in primals]
        pairs = [(o, c) for o, c in zip(fn(*primals), cotangents)
                 if c is not None]
        grads = torch.autograd.grad([o for o, _ in pairs], primals,
                                    [c for _, c in pairs])
    return tuple(g.contiguous() for g in grads)
