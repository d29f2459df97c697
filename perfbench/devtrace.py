"""Readings of a profiler window of the device: its events, how long the
device was busy, the operations that took most time and the idle gaps.

An event is ``(name, start_ns, end_ns)`` of a device-side activity
(kernel, copy or set) as ``torch.profiler`` records it with CUDA activity
only: host-side events would slow the host-paced loops the window
measures.  Times are summed straight from the profiler's raw events, as
``key_averages`` sums them (an asynchronous event, or one that ends on
another thread, counts with no time), without building a Python object
an event first.
"""
from __future__ import annotations

import re

import torch

COPIES = ("Memcpy", "Memset")


def events_of(prof) -> list:
    out = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_hidden_event", lambda: False)()
                or e.name().startswith("Activity Buffer")):
            continue
        if e.is_async() or e.start_thread_id() != e.end_thread_id():
            continue
        out.append((e.name(), int(e.start_ns()), int(e.end_ns())))
    out.sort(key=lambda ev: ev[1])
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(COPIES)


def busy_ns(events) -> int:
    """Length of the union of the events' intervals."""
    total, end = 0, None
    for _, s, e in events:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


_WRAPPERS = {"BinaryFunctor", "AUnaryFunctor", "BUnaryFunctor",
             "UnaryFunctor"}
_FUNCTOR = re.compile(r"(\w*Functor\w*)(?:<([\w:]+))?")
_LAMBDA = re.compile(r"::(\w+)\((?:at::)?TensorIterator")


def short(name: str, width: int = 100) -> str:
    """A device event's readable name: the kernel's function, and for
    PyTorch's templated kernels the functor or the operator it runs
    (``vectorized_elementwise_kernel[MulFunctor<float>]``)."""
    if name.startswith(COPIES):
        return name[:width]
    base = kernel_base(name) or name[:width]
    functors = [(f, t) for f, t in _FUNCTOR.findall(name)
                if f not in _WRAPPERS] or _FUNCTOR.findall(name)
    lam = _LAMBDA.findall(name)
    if functors:
        f, t = functors[-1]
        base += f"[{f}<{t}>]" if t else f"[{f}]"
    elif lam:
        base += f"[{lam[0]}]"
    return base[:width]


def top_ops(events, m: int = 10) -> list:
    """[[name, seconds]] of the ``m`` names (``short``) with the most
    device time."""
    by_name, tot = {}, {}
    for name, s, e in events:
        by_name[name] = by_name.get(name, 0) + (e - s)
    for name, ns in by_name.items():
        tot[short(name)] = tot.get(short(name), 0) + ns
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:m]
    return [[nm, ns / 1e9] for nm, ns in ranked]


def idle_gaps(events, m: int = 10) -> list:
    """[[label, seconds]]: the device's idle time between activities,
    summed by what ran on either side of the gap (``after A / before
    B``), the ``m`` largest sums.  A gap the host leaves before a copy
    from the device is the host waiting on a result."""
    pairs, end, prev = {}, None, None
    for name, s, e in events:
        if end is not None and s > end:
            pairs[prev, name] = pairs.get((prev, name), 0) + (s - end)
        if end is None or e > end:
            end, prev = e, name
    tot = {}
    for (a, b), ns in pairs.items():
        label = f"after {short(a, 48)} / before {short(b, 48)}"
        tot[label] = tot.get(label, 0) + ns
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:m]
    return [[lb, ns / 1e9] for lb, ns in ranked]


def kernel_base(name: str) -> str:
    """A device event's function name: ``void ns::f<T>(...)`` -> ``f``."""
    head = name[5:] if name.startswith("void ") else name
    head = head.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", head, maxsplit=1)[0]
    return head.rsplit("::", 1)[-1].strip()
