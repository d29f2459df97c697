"""Roofline terms of one step on an H100 mesh: the port of
``repro/roofline.py``.

Three terms per (arch x shape x mesh):

    compute    = FLOPs / (chips x peak FLOP/s)
    memory     = HBM bytes / (chips x HBM bytes/s)
    collective = collective bytes / (chips x NET_BW)

The JAX package reads them off XLA's compiled, SPMD-partitioned HLO
(``analyze_hlo``).  The port has no compiled program: ``analyze_step``
runs the step itself, eagerly, on the device's local tensors, and counts
what each device runs (``StepCounter``).  ``RooflineTerms``,
``roofline()`` and ``model_flops()`` are the JAX package's.

The collective term divides by ``NET_BW``, one card's share of the
network between hosts, not by ``NVLINK_BW``: the production meshes'
16-wide axes do not fit in one host of 8 cards, so a ring over such an
axis crosses hosts, and its slowest link sets its pace.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM (data sheet, dense rates without sparsity, 700 W):
PEAK_FLOPS_BF16 = 989e12     # FLOP/s a card, bf16 on the tensor cores
HBM_BW = 3.35e12             # B/s a card, HBM3
# NVLink 4 (DGX H100): 900 GB/s a card to the other cards of its host
NVLINK_BW = 450e9            # B/s a card, each way
# DGX H100 networking: one 400 Gb/s ConnectX-7 (InfiniBand NDR) a card
NET_BW = 50e9                # B/s a card, between hosts

#: JAX's collective kinds (``repro.roofline._COLLECTIVES``) and the op
#: names of the collectives that DTensor issues, by kind
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND_OF = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
            ("permute", "collective-permute"),
            ("broadcast", "collective-permute"))
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")
#: ops that move no bytes: allocation without a write, and a
#: collective's completion and autograd wrappers
_FREE = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                   "new_empty_strided", "wait_tensor",
                   "_wrap_tensor_autograd", "lift_fresh"})


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _collective_kind(func):
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns not in _COLLECTIVE_NAMESPACES:
        return None
    return next((kind for key, kind in _KIND_OF if key in name), None)


class StepCounter(TorchDispatchMode):
    """Counts, for one device, what the ops run inside it cost.

    The mode declines every op on a DTensor (``NotImplemented``), so
    DTensor runs it as the device would (its sharding rules, then the op
    on the local tensors, and the ``_c10d_functional`` collectives that a
    redistribution issues) and the mode sees each of those local ops.  It
    skips the ops that DTensor runs under its own ``FakeTensorMode`` to
    find a result's global shape.  Per device:
    - ``flops``: ``torch.utils.flop_counter``'s formula of each op that
      has one (products, convolutions, attention, and the port's kernel
      ops, which register theirs);
    - ``bytes``: operand plus result bytes of every op that is not a
      view (an in-place op's written operand counted once), the eager
      analogue of XLA's top-level instructions;
    - ``collectives``: result bytes of each collective, by JAX's kinds,
      and ``_total``;
    - ``peak_bytes``: the most bytes of storage that ops made inside the
      mode and that were alive at once (what the step holds beyond its
      arguments).
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = dict.fromkeys(COLLECTIVES, 0)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = {}

    def _freed(self, key, nbytes, _ref):
        self._live.pop(key, None)
        self.live_bytes -= nbytes

    def _track(self, t) -> None:
        st = t.untyped_storage()
        if st._cdata in self._live:
            return
        n = st.nbytes()
        self._live[st._cdata] = weakref.ref(
            st, lambda r, k=st._cdata, n=n: self._freed(k, n, r))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out        # DTensor finding a global shape
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        schema = func._schema
        aliases = [r.alias_info for r in schema.returns
                   if r.alias_info is not None]
        outs = _tensors(out)
        if not aliases:           # fresh storage
            for t in outs:
                self._track(t)
        if schema.name.split("::")[-1] in _FREE:
            return out
        if aliases and not any(a.is_write for a in aliases):
            return out            # a view: no bytes move
        ins = _tensors((args, kwargs))
        mutated = {id(t) for t in outs} if aliases else set()
        rbytes = sum(map(_nbytes, outs))
        self.bytes += rbytes + sum(_nbytes(t) for t in ins
                                   if id(t) not in mutated)
        kind = _collective_kind(func)
        if kind is not None:
            self.collectives[kind] += rbytes
        return out

    def result(self) -> dict:
        coll = dict(self.collectives)
        coll["_total"] = sum(coll.values())
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collectives": coll}


def analyze_step(fn, *args, **kwargs) -> dict:
    """Per-device cost of ``fn(*args, **kwargs)``, run eagerly under a
    ``StepCounter``: dict(flops, bytes, collectives={kind: bytes,
    _total}), the keys of the JAX package's ``analyze_hlo``.  Loops run
    as often as they run, so nothing is multiplied by a trip count."""
    with StepCounter() as counter:
        fn(*args, **kwargs)
    return counter.result()


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_hbm: float
    bytes_collective: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> dict:
        return dict(compute_s=self.compute_s, memory_s=self.memory_s,
                    collective_s=self.collective_s, dominant=self.dominant,
                    flops=self.flops, bytes_hbm=self.bytes_hbm,
                    bytes_collective=self.bytes_collective)


def roofline(cost_analysis: dict, coll_bytes: float,
             chips: int) -> RooflineTerms:
    flops = float(cost_analysis.get("flops", 0.0))
    byts = float(cost_analysis.get("bytes accessed", 0.0))
    return RooflineTerms(
        compute_s=flops / (chips * PEAK_FLOPS_BF16),
        memory_s=byts / (chips * HBM_BW),
        collective_s=coll_bytes / (chips * NET_BW),
        flops=flops, bytes_hbm=byts, bytes_collective=coll_bytes,
        chips=chips)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode D = B."""
    from repro_torch.models.model import active_params
    n = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch   # decode: one token per sequence
