"""H2O-Danube-1.8B [arXiv:2401.16818] — llama+mistral mix with sliding-window
attention. 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, window 4096.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o_danube_1_8b", family="dense",
    num_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32_000,
    attn_type="swa", window=4096,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    arch_id="h2o_danube_1_8b", family="dense",
    num_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab=256,
    attn_type="swa", window=16,
)
