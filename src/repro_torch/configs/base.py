"""Model / shape configuration system.

``ModelConfig`` is a frozen, hashable dataclass covering every assigned
architecture family (dense GQA, MLA, MoE, SSM, hybrid, enc-dec, VLM).  One
``src/repro_torch/configs/<arch>.py`` per assigned architecture instantiates it
with the published dimensions; ``registry.py`` resolves ``--arch``/``--shape``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size_raw: int
    head_dim: int = 128
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_pct: float = 1.0       # stablelm-2 uses partial rotary (25%)
    tie_embeddings: bool = False
    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1          # MoE layer every N layers (llama4: 2)
    first_dense: int = 0        # deepseek-v2: first layer is dense
    dense_d_ff: int = 0         # d_ff of dense layers inside MoE models
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_kernel: int = 4
    # --- hybrid (zamba2): shared attention block every N mamba layers ---
    attn_every: int = 0
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0            # precomputed frame embeddings (conv stub)
    # --- vlm (llava): patch embeddings prepended (projector stub) ---
    n_patches: int = 0
    # --- attention window (llama4 long-context chunked attention) ---
    sliding_window: int = 0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # sharding divisibility (model axis); vocab is padded to this multiple
    shard_multiple: int = 16

    @property
    def vocab_size(self) -> int:
        """Vocabulary padded for even sharding over the model axis."""
        return _round_up(self.vocab_size_raw, 128)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_head_dim(self) -> int:
        return self.d_inner // max(self.ssm_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM/hybrid/windowed attention)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def n_params(self) -> int:
        """Parameter count (for 6ND model-FLOPs accounting), from the
        parameter shapes of ``models.model`` (nothing is allocated)."""
        from repro_torch.models import model as model_lib
        return model_lib.count_params(self)

    def validate(self) -> None:
        assert self.d_model % self.shard_multiple == 0, self.name
        assert self.vocab_size % 128 == 0, self.name
        if self.n_heads:
            assert (self.n_heads * self.head_dim) % self.shard_multiple == 0
        if self.n_experts:
            assert self.n_experts % self.shard_multiple == 0 or \
                self.shard_multiple % self.n_experts == 0, \
                f"{self.name}: experts must tile the model axis"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assigned-cell applicability rules (see DESIGN.md §5)."""
    if shape.name == "long_500k" and not model.subquadratic:
        return False, "pure full-attention arch: 500k decode skipped (DESIGN.md §5)"
    return True, ""
