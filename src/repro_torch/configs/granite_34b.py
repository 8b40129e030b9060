"""Granite-34B-Code [arXiv:2405.04324] — GPT-BigCode arch with MQA.

88L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152, non-gated GELU MLP.
Deviation (DESIGN.md §4): learned absolute positions (ctx 8k) replaced with
RoPE so the 32k shapes are well-defined.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite_34b", family="dense",
    num_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24_576, vocab=49_152,
    attn_type="gqa", mlp_gated=False,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    arch_id="granite_34b", family="dense",
    num_layers=3, d_model=64, n_heads=8, n_kv_heads=1,
    d_ff=256, vocab=256,
    attn_type="gqa", mlp_gated=False,
)
