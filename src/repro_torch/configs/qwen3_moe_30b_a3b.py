"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — MoE, 128 experts top-8.

48L d_model=2048 32H (GQA kv=4, head_dim=128, q/k-norm) expert d_ff=768
vocab=151936. Expert dispatch uses the Sphere bucket shuffle (DESIGN.md §4).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3_moe_30b_a3b", family="moe",
    num_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=0, vocab=151_936,
    attn_type="gqa", head_dim=128, qk_norm=True,
    num_experts=128, top_k=8, expert_d_ff=768,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    arch_id="qwen3_moe_30b_a3b", family="moe",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=0, vocab=256,
    attn_type="gqa", head_dim=16, qk_norm=True,
    num_experts=8, top_k=2, expert_d_ff=32,
)
