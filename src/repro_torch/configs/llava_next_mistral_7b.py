"""llava-next-mistral-7b [vlm] — Mistral-7B backbone: 32L d_model=4096 32H
(GQA kv=8) hd=128 d_ff=14336 vocab=32000; anyres vision tower + projector
STUBBED: input_specs() provides patch embeddings [B, 576, 4096]
(hf:llava-hf/llava-v1.6-mistral-7b-hf)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size_raw=32000, rope_theta=1e6,
    n_patches=576,
)
