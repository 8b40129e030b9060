"""TinyLlama-1.1B [arXiv:2401.02385] — llama2-arch small.

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="tinyllama_1_1b", family="dense",
    num_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32_000,
    attn_type="gqa",
    rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    arch_id="tinyllama_1_1b", family="dense",
    num_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab=256,
    attn_type="gqa",
)
