"""InternVL2-1B [arXiv:2404.16821] — InternViT frontend (STUB) + Qwen2-0.5B LM.

LM backbone: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
The ViT is a stub: ``input_specs()`` provides precomputed patch embeddings
(batch, img_tokens, d_model) prepended to the text sequence; loss is computed
on text positions only.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2_1b", family="vlm",
    num_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151_655,
    attn_type="gqa",
    img_tokens=256,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    arch_id="internvl2_1b", family="vlm",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    attn_type="gqa",
    img_tokens=8,
)
