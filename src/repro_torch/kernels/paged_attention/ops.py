"""Dispatch of paged decode attention: the tensor's device decides.

A CPU ``q`` goes to the plain version (ref.py); a CUDA ``q`` goes to the
hand-written kernels (kernel.py), whose wrapper raises on anything they
cannot take.  There is no switch that pins the plain version on the card
and no fallback from a failed build or launch.
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention import kernel, ref


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                    page_mass: bool = False):
    """One-token GQA decode attention over a page table
    (``ref.paged_attention_ref``).  Returns ``out [B, H, dh]``, or
    ``(out, mass [B, n_pp])`` with ``page_mass``."""
    if q.device.type == "cuda":
        return kernel.paged_attention(q, k_pages, v_pages, block_tables,
                                      seq_lens, page_mass=page_mass)
    if q.device.type != "cpu":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   seq_lens, page_mass=page_mass)
