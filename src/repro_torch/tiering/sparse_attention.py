"""Beyond-paper serving mode: ARMS-guided sparse paged attention, in torch.

The port of ``repro/tiering/sparse_attention.py``.  The paper places hot
pages in the fast tier so that full attention is cheap; the step beyond
the paper lets the policy's hot set *define the attention working set*:
attend only to (a) fast-resident pages, (b) a recency window of the
newest pages, and (c) the attention-sink page 0.  The cold slow-tier
pages are skipped, so both the slow-tier bandwidth and the attention
compute shrink by the cold-set fraction.  The approximation error is
bounded by the skipped attention mass.

The JAX package computes this in plain XLA, outside any Pallas kernel,
so plain torch (einsum, masked softmax) over the gathered pages
(``paged_kv.gather_kv``) is its port.
"""
from __future__ import annotations

import torch

from repro_torch.tiering.paged_kv import PagedKV, PagedKVConfig, gather_kv


def sparse_attention_step(kv: PagedKV, q, pos: int, cfg: PagedKVConfig,
                          recent_pages: int = 2):
    """Decode attention over ONLY the hot working set.

    q ``[B, H, dh]`` -> (out ``[B, H, dh]``, page mass ``[n_pages]``,
    attended fraction of the valid pages, f32 scalar).
    """
    B, H, dh = q.shape
    page, n = cfg.page_size, cfg.n_pages
    dev = q.device
    k, v = gather_kv(kv)                            # [n, page, B, KV, dh]
    KV = k.shape[3]
    rep = H // KV

    cur_page = pos // page
    page_ids = torch.arange(n, device=dev)
    attend = (kv.in_fast                                    # the hot set
              | (page_ids >= cur_page - recent_pages + 1)
              & (page_ids <= cur_page)                      # recency window
              | (page_ids == 0))                            # attention sink

    kf = k.permute(2, 0, 1, 3, 4).reshape(B, n * page, KV, dh)
    vf = v.permute(2, 0, 1, 3, 4).reshape(B, n * page, KV, dh)
    qg = q.reshape(B, KV, rep, dh)
    s = torch.einsum("bkrd,bskd->bkrs", qg, kf).float() * dh ** -0.5
    tok_ok = (attend.repeat_interleave(page)
              & (torch.arange(n * page, device=dev) <= pos))[None]
    s = torch.where(tok_ok[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", p.to(vf.dtype), vf)
    mass = p.reshape(B, KV, rep, n, page).sum(dim=(0, 1, 2, 4))
    frac = attend.sum() / torch.clamp_min(
        (page_ids * page <= pos).sum(), 1)
    return out.reshape(B, H, dh), mass, frac
