"""stablelm-1.6b [dense] — 24L d_model=2048 32H (kv=32) hd=64 d_ff=5632
vocab=100352, partial rotary 25% (hf:stabilityai/stablelm-2-1_6b)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size_raw=100352, rope_pct=0.25,
)
