"""Zamba2-1.2B [arXiv:2411.15242] — Mamba2 backbone + shared attention block.

38 Mamba2 blocks, d_model=2048, ssm_state=64; one *shared* transformer block
(32H attention + d_ff=8192 MLP, weights reused) applied before every 6th
Mamba block. vocab=32000.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2_1_2b", family="hybrid",
    num_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32_000,
    attn_type="gqa",
    ssm_state=64, ssm_expand=2, conv_kernel=4, chunk_size=256,
    attn_every=6,
    scan_layers=False,
)

SMOKE_CONFIG = ModelConfig(
    arch_id="zamba2_1_2b", family="hybrid",
    num_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    attn_type="gqa",
    ssm_state=16, ssm_expand=2, conv_kernel=4, chunk_size=8,
    attn_every=2,
    scan_layers=False,
)
