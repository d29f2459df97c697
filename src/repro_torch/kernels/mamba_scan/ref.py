"""Plain PyTorch version of the Mamba2 SSD chunked scan.

The contract of the CUDA kernels (kernel.py) and what the op runs for
tensors on the CPU: the port of ``repro/models/mamba2.py``'s ``_segsum``
and ``ssd_chunked`` op for op (an inclusive ``cumsum`` of dt * A within
each chunk, the intra-chunk decay masked at -inf before ``exp``, the
chunk states, a sequential loop over chunks carrying the ``[P, N]``
state, the off-diagonal term from the carried states).  Autograd through
it gives the plain gradient.  ``models/mamba2.py`` imports it from here
(the JAX package's ``ref.py`` imports the model; here the model imports
the op, so the function lives with the op and the model re-exports it).
"""
from __future__ import annotations

import torch


def segsum(dA):
    """dA: ``[..., Q]`` -> ``[..., Q, Q]``: sum_{j<m<=i} dA_m for i >= j,
    else -inf."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # [.., i, j]
    keep = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    return torch.where(keep, diff, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan.

    x: ``[B, S, H, P]`` (pre-multiplied inputs), dt: ``[B, S, H]``
    (post-softplus), A: ``[H]`` (negative), Bm/Cm: ``[B, S, N]`` (single
    group).  Returns ``(y [B, S, H, P], final_state [B, H, P, N])``."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of {Q}")
    nc = S // Q

    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    dA = dtc * A                                         # [b,c,q,h] (<=0)
    dA_h = dA.permute(0, 1, 3, 2)                        # [b,c,h,q]
    dA_cs = torch.cumsum(dA_h, dim=-1)                   # [b,c,h,q]

    # 1. intra-chunk (diagonal blocks)
    Lmat = torch.exp(segsum(dA_h))                       # [b,c,h,q,q]
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)         # [b,c,q,k]
    xdt = xc * dtc[..., None]                            # [b,c,q,h,p]
    y_diag = torch.einsum("bchqk,bcqk,bckhp->bcqhp",
                          Lmat, CB.to(Lmat.dtype), xdt)

    # 2. per-chunk input states (decay to end of chunk)
    decay_end = torch.exp(dA_cs[..., -1:] - dA_cs)       # [b,c,h,q]
    states = torch.einsum("bcqn,bchq,bcqhp->bchpn",
                          Bc, decay_end * dtc.permute(0, 1, 3, 2), xc)

    # 3. inter-chunk recurrence (sequential over chunks)
    chunk_decay = torch.exp(dA_cs[..., -1])              # [b,c,h]
    h = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device) \
        if init_state is None else init_state
    carried = []                                         # state BEFORE chunk
    for c in range(nc):
        carried.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    carried = torch.stack(carried, dim=1)                # [b,c,h,p,n]

    # 4. off-diagonal contribution from carried states
    decay_out = torch.exp(dA_cs)                         # [b,c,h,q]
    y_off = torch.einsum("bcqn,bchpn,bchq->bcqhp", Cc, carried, decay_out)

    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y, h


def mamba_scan_ref(x, dt, A, Bm, Cm, chunk: int):
    """The op's contract: ``ssd_chunked`` computed in f32 (a bf16 ``x``
    is widened first, as the JAX test feeds its reference), y returned in
    x's dtype, the final state in f32."""
    y, h = ssd_chunked(x.float(), dt, A, Bm, Cm, chunk)
    return y.to(x.dtype), h
