"""Config schema + registry for the assigned architectures and input shapes."""

from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


#: The assigned input-shape set (identical for every LM-family arch).
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                       # dense | moe | audio | ssm | vlm | hybrid
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    attn_type: str = "gqa"            # gqa | mla | swa
    head_dim: Optional[int] = None    # default d_model // n_heads
    window: Optional[int] = None      # sliding-window size (attn_type=swa)
    qk_norm: bool = False             # qwen3-style per-head q/k RMSNorm
    rope_theta: float = 10_000.0

    # MLA (minicpm3 / deepseek-v2 style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    moe_impl: str = "sphere"          # sphere (paper bucket shuffle) | dense
    capacity_factor: float = 1.25

    # SSM / xLSTM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256             # SSD / mLSTM chunk length
    slstm_every: int = 0              # xlstm: every k-th block is sLSTM
    attn_every: int = 0               # zamba2: shared attn before every k-th block

    # enc-dec (whisper)
    enc_layers: int = 0
    enc_seq: int = 0                  # encoder frames (stub embeddings)

    # VLM (internvl)
    img_tokens: int = 0               # patch embeddings prepended to text

    # MLP
    mlp_gated: bool = True            # SwiGLU vs plain GELU
    residual_scale: float = 1.0       # minicpm depth-scaled residuals

    # numerics / execution
    tp_size: int = 16                 # production model-axis size; gates
    #                                   head-granular weight sharding
    norm_eps: float = 1e-5
    remat: bool = True
    scan_layers: bool = True
    logit_cap: float = 0.0

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def runnable_shapes(self) -> List[str]:
        """Which assigned shapes this arch runs (long_500k only for archs with
        sub-quadratic / bounded-state attention — see DESIGN.md)."""
        out = ["train_4k", "prefill_32k", "decode_32k"]
        subquad = (self.family in ("ssm", "hybrid")
                   or self.attn_type == "swa")
        if subquad:
            out.append("long_500k")
        return out


ARCH_IDS: Tuple[str, ...] = (
    "minicpm3_4b", "h2o_danube_1_8b", "granite_34b", "tinyllama_1_1b",
    "qwen3_moe_30b_a3b", "qwen2_moe_a2_7b", "whisper_small", "xlstm_125m",
    "internvl2_1b", "zamba2_1_2b",
)


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.SMOKE_CONFIG
