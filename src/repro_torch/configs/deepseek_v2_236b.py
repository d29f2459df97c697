"""deepseek-v2-236b [moe] — MLA kv_lora=512 q_lora=1536, 60L d_model=5120
128H (qk_nope 128 + qk_rope 64, v 128), 2 shared + 160 routed experts
top-6 (expert d_ff=1536), first layer dense d_ff=12288, vocab=102400
(arXiv:2405.04434)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab_size_raw=102400,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
    v_head_dim=128,
    n_experts=160, experts_per_token=6, n_shared_experts=2, moe_d_ff=1536,
    first_dense=1, dense_d_ff=12288,
)
