"""mamba2-370m [ssm] — SSD (state-space duality, arXiv:2405.21060).
48L d_model=1024 attn-free, ssm_state=128, headdim 64 -> 32 heads,
vocab=50280 (padded 50304 for sharding)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size_raw=50280,
    ssm_state=128, ssm_heads=32, ssm_expand=2, ssm_chunk=64,
)
