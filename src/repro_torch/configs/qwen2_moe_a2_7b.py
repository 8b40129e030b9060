"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed experts top-4
plus 4 shared experts. 24L d_model=2048 16H (MHA kv=16) expert d_ff=1408
vocab=151936. Routed dispatch = Sphere bucket shuffle; shared experts run
dense on every token (4 x 1408 = the HF config's fused 5632 shared FFN).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2_moe_a2_7b", family="moe",
    num_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=151_936,
    attn_type="gqa",
    num_experts=60, top_k=4, expert_d_ff=1408,
    n_shared_experts=4, shared_d_ff=1408,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    arch_id="qwen2_moe_a2_7b", family="moe",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=256,
    attn_type="gqa",
    num_experts=6, top_k=2, expert_d_ff=32,
    n_shared_experts=2, shared_d_ff=32,
)
