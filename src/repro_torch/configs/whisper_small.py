"""Whisper-small [arXiv:2212.04356] — encoder-decoder, audio.

12L enc + 12L dec, d_model=768 12H (MHA) d_ff=3072 vocab=51865, non-gated
GELU. The conv frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings (batch, enc_seq, d_model). Encoder frames fixed at the
native 1500 (30 s); the assigned seq_len applies to the decoder side.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper_small", family="audio",
    num_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51_865,
    attn_type="gqa", mlp_gated=False,
    enc_layers=12, enc_seq=1500,
)

SMOKE_CONFIG = ModelConfig(
    arch_id="whisper_small", family="audio",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    attn_type="gqa", mlp_gated=False,
    enc_layers=2, enc_seq=32,
)
