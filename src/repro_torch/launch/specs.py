"""``meta`` tensor stand-ins for every model input: the port of
``repro/launch/specs.py``.

A ``meta`` tensor has a shape and a dtype and no storage, as a JAX
``ShapeDtypeStruct`` has; the dry run (``launch/dryrun.py``) shards and
runs the steps on them.  Stub-frontend archs get precomputed frame/patch
embeddings (the modality frontend is a stub), as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import model as M

META = "meta"


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg, shape, with_labels: bool = True) -> dict:
    """Training / prefill batch stand-ins."""
    B, S = shape.global_batch, shape.seq_len
    dtype = L.dtype_of(cfg)
    spec = {}
    if cfg.family == "vlm":
        spec["tokens"] = _sds((B, S - cfg.n_patches), torch.int32)
        spec["patch_embeds"] = _sds((B, cfg.n_patches, cfg.d_model), dtype)
        if with_labels:
            spec["labels"] = _sds((B, S - cfg.n_patches), torch.int32)
    elif cfg.family == "encdec":
        spec["tokens"] = _sds((B, S), torch.int32)
        spec["audio_embeds"] = _sds((B, cfg.enc_seq, cfg.d_model), dtype)
        if with_labels:
            spec["labels"] = _sds((B, S), torch.int32)
    else:
        spec["tokens"] = _sds((B, S), torch.int32)
        if with_labels:
            spec["labels"] = _sds((B, S), torch.int32)
    return spec


def decode_specs(cfg, shape):
    """(token, cache, pos) stand-ins for ``serve_step``; ``pos`` an i32
    scalar, as JAX's (the port's decode takes it as a host int)."""
    B, S = shape.global_batch, shape.seq_len
    cache = M.init_cache(cfg, B, S, device=META)
    return _sds((B, 1), torch.int32), cache, _sds((), torch.int32)


def param_specs(cfg) -> dict:
    return M.init_params(cfg, torch.Generator(), device=META)


def opt_specs(cfg, opt_cfg, params_sds):
    from repro_torch.optim import adamw
    return adamw.init(params_sds, opt_cfg)


def input_specs(cfg, shape) -> dict:
    """All inputs for the step function of this (arch x shape) cell."""
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape, with_labels=False)}
    token, cache, pos = decode_specs(cfg, shape)
    return {"token": token, "cache": cache, "pos": pos}
