"""Plain PyTorch version of paged decode attention.

The contract of the CUDA kernels (kernel.py) and what the op runs for
tensors on the CPU: the port of ``repro/kernels/paged_attention/ref.py``
(gather the table's pages, f32 softmax, probabilities cast to V's dtype
before the second product), with the output in ``q``'s dtype and, on
request, each table entry's attention mass, which the serving layer
(``tiering/paged_kv.py``) feeds to its placement policy.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_tables, seq_lens, *,
                        page_mass: bool = False):
    """Decode attention over a paged KV cache.

    q ``[B, H, dh]``; k/v pages ``[P, page, KV, dh]``; block_tables i32
    ``[B, n_pp]``; seq_lens i32 ``[B]`` (tokens at or past it are masked).
    Table entries out of the pools' range are clamped into it.
    Returns ``out [B, H, dh]`` in ``q.dtype``, and with ``page_mass`` also
    ``mass [B, n_pp]`` f32: the softmax probabilities of each entry's
    tokens summed over heads (summed in f64, rounded once).
    """
    B, H, dh = q.shape
    page, KV = k_pages.shape[1], k_pages.shape[2]
    rep = H // KV
    n_pp = block_tables.shape[1]
    idx = block_tables.long().clamp(0, k_pages.shape[0] - 1)
    k = k_pages[idx].reshape(B, n_pp * page, KV, dh)
    v = v_pages[idx].reshape(B, n_pp * page, KV, dh)
    qg = q.reshape(B, KV, rep, dh)
    s = torch.einsum("bkrd,bskd->bkrs", qg, k).float() * dh ** -0.5
    valid = (torch.arange(n_pp * page, device=q.device)[None]
             < seq_lens.to(q.device)[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", p.to(v.dtype), v)
    out = out.reshape(B, H, dh).to(q.dtype)
    if not page_mass:
        return out
    mass = p.double().reshape(B, KV, rep, n_pp, page).sum(dim=(1, 2, 4))
    return out, mass.float()
