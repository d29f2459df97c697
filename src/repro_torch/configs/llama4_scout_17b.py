"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) hd=128,
MoE 16 experts top-1 + shared expert on alternating layers, d_ff=8192,
vocab=202048; iRoPE-style chunked local attention (window 8192) keeps the
decode working set bounded -> long_500k eligible
(hf:meta-llama/Llama-4-Scout-17B-16E)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, dense_d_ff=8192, vocab_size_raw=202048, rope_theta=5e5,
    n_experts=16, experts_per_token=1, n_shared_experts=1, moe_d_ff=8192,
    moe_every=2, sliding_window=8192,
)
