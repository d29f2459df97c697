"""Architecture / shape registry: resolves ``--arch`` and ``--shape``.

Also provides ``reduced(cfg)`` — a structure-preserving shrink of any config
(small width, few layers/experts, tiny vocab) used by the per-arch CPU smoke
tests; the FULL configs are only ever lowered via ShapeDtypeStructs in the
dry-run.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_v2_236b, granite_8b,
                           llama4_scout_17b, llava_next_mistral_7b,
                           mamba2_370m, mistral_nemo_12b, qwen3_14b,
                           stablelm_1p6b, whisper_small, zamba2_1p2b)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                shape_applicable)

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    zamba2_1p2b, mistral_nemo_12b, stablelm_1p6b, qwen3_14b, granite_8b,
    llama4_scout_17b, deepseek_v2_236b, mamba2_370m, whisper_small,
    llava_next_mistral_7b)}

# short aliases for --arch
ALIASES = {
    "zamba2": "zamba2-1.2b",
    "mistral-nemo": "mistral-nemo-12b",
    "stablelm": "stablelm-1.6b",
    "qwen3": "qwen3-14b",
    "granite": "granite-8b",
    "llama4-scout": "llama4-scout-17b-16e",
    "deepseek-v2": "deepseek-v2-236b",
    "mamba2": "mamba2-370m",
    "whisper": "whisper-small",
    "llava-next": "llava-next-mistral-7b",
}


def get_arch(name: str) -> ModelConfig:
    cfg = ARCHS.get(ALIASES.get(name, name))
    if cfg is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    cfg.validate()
    return cfg


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells():
    """All 40 assigned (arch x shape) cells with applicability verdicts."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            ok, why = shape_applicable(arch, shape)
            yield arch, shape, ok, why


def reduced(cfg: ModelConfig, seq_hint: int = 32) -> ModelConfig:
    """Structure-preserving tiny variant for CPU smoke tests."""
    over = dict(
        name=cfg.name + "-smoke",
        d_model=64,
        d_ff=min(cfg.d_ff, 128) if cfg.d_ff else 0,
        vocab_size_raw=256,
        dtype="float32",
        shard_multiple=1,
    )
    if cfg.n_heads:
        over.update(n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads
                    else 4, head_dim=16)
    if cfg.family == "hybrid":
        over.update(n_layers=5, attn_every=2, ssm_state=16, ssm_heads=4,
                    d_ff=128)
    elif cfg.family == "ssm":
        over.update(n_layers=4, ssm_state=16, ssm_heads=4, ssm_chunk=8)
    elif cfg.family == "moe":
        if cfg.use_mla:
            over.update(n_layers=3, n_experts=8, experts_per_token=2,
                        n_shared_experts=1, moe_d_ff=32, dense_d_ff=128,
                        kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16,
                        v_head_dim=16)
        else:
            over.update(n_layers=4, n_experts=8, experts_per_token=1,
                        n_shared_experts=1, moe_d_ff=64, dense_d_ff=128,
                        sliding_window=16 if cfg.sliding_window else 0)
    elif cfg.family == "encdec":
        over.update(n_layers=2, n_enc_layers=2, enc_seq=16)
    elif cfg.family == "vlm":
        over.update(n_layers=2, n_patches=8)
    else:
        over.update(n_layers=2)
    return dataclasses.replace(cfg, **over)
