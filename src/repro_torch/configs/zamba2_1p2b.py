"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block every 6
layers (arXiv:2411.15242).  38L d_model=2048, MHA 32H hd=64 (kv=32),
shared-block d_ff=8192, vocab 32000, ssm_state=64."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size_raw=32000,
    ssm_state=64, ssm_heads=64, ssm_expand=2, ssm_chunk=64,
    attn_every=6,
)
