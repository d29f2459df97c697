"""whisper-small [audio] — enc-dec 12L+12L d_model=768 12H hd=64 d_ff=3072
vocab=51865 (padded 51968); conv frontend STUBBED: input_specs() provides
precomputed frame embeddings [B, 1500, 768] (arXiv:2212.04356)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size_raw=51865,
    n_enc_layers=12, enc_seq=1500,
)
