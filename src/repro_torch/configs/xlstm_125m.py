"""xLSTM-125M [arXiv:2405.04517] — sLSTM + mLSTM blocks.

12L d_model=768, 4 heads, vocab=50304, d_ff=0 (the xLSTM block carries its
own up/down projection, expansion 2). Block ratio ~ mLSTM[7:1]sLSTM: every
6th block is sLSTM (2 of 12), the rest mLSTM. mLSTM runs in chunked-parallel
form for train/prefill and recurrent form for decode; sLSTM is sequential
(lax.scan over time) by construction.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm_125m", family="ssm",
    num_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50_304,
    ssm_expand=2, ssm_heads=4, chunk_size=256,
    slstm_every=6,
    scan_layers=False,
)

SMOKE_CONFIG = ModelConfig(
    arch_id="xlstm_125m", family="ssm",
    num_layers=3, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=256,
    ssm_expand=2, ssm_heads=2, chunk_size=8,
    slstm_every=3,
    scan_layers=False,
)
