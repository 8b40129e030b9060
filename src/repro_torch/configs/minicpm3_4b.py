"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — dense, MLA attention.

62L d_model=2560 40H d_ff=6400 vocab=73448; MLA dims from the HF config
(q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64);
depth-scaled residuals (scale_depth=1.4 -> 1.4/sqrt(62) per residual).
"""

import math

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm3_4b", family="dense",
    num_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73_448,
    attn_type="mla",
    q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    residual_scale=1.4 / math.sqrt(62),
    rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    arch_id="minicpm3_4b", family="dense",
    num_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    attn_type="mla",
    q_lora_rank=32, kv_lora_rank=16,
    qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8,
    residual_scale=1.4 / math.sqrt(3),
)
