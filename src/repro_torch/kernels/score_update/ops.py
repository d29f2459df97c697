"""Dispatch of the single-row score update: the tensor's device decides.

A CPU tensor goes to the plain version (``interval_step.ref``'s
``ewma_score_update_ref`` on one lane); a CUDA tensor goes to the
hand-written kernel (kernel.py), whose wrapper raises on anything it
cannot take.  There is no ``use_kernel`` switch: the port pins nothing to
the plain version on the card, and no build or launch failure falls back.

The classifier does not use this op: ``core.classifier.update_scores``
runs the lane-batched ``interval_step.ops.ewma_score_update``, as the JAX
package's does.  This op is the single-row form, the JAX package's
``score_update`` (whose only caller is its framework-scale benchmark).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.interval_step.ref import ewma_score_update_ref
from repro_torch.kernels.score_update import kernel
from repro_torch.utils.device import f32_on


def score_update(ewma_s, ewma_l, counts, *, alpha_s, alpha_l, w_s, w_l):
    """Dual EWMA + hotness score over f32 ``[n]`` rows; each parameter a
    Python float or a 0-d tensor.  -> ``(ewma_s', ewma_l', score)``.

    ``s' = fma(a_s, c, (1-a_s)*s)``, ``l'`` alike, ``score = fma(w_s, s',
    w_l*l')``, each ``fma`` rounded once: the roundings of the JAX
    reference ``score_update_ref`` under ``jit``.  The JAX kernel's ``s'``
    and ``l'`` are these bits; its ``score`` is within 2 ulp of them
    (ROADMAP queue 3)."""
    dev = ewma_s.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"score_update runs on cuda or cpu, not {dev}")
    params = torch.stack([f32_on(v, dev).reshape(())
                          for v in (alpha_s, alpha_l, w_s, w_l)])
    if dev.type == "cuda":
        return kernel.score_update(ewma_s, ewma_l, counts, params)
    return tuple(o[0] for o in ewma_score_update_ref(
        ewma_s[None], ewma_l[None], counts[None], params[None]))
