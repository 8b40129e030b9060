"""Decoder-only LM assembly: block patterns, the layer loop, caches.

Port of the ``dense`` and ``moe`` patterns of
``repro/models/transformer.py`` (the ``mamba``/``mlstm``/``slstm``/
``shared_attn`` blocks, the VLM image path and ``train_loss`` wait; see
``ROADMAP.md``). The JAX package scans homogeneous stacks over stacked
parameters, with ``remat``; at inference neither has a meaning here, so
:func:`forward` is a loop over :class:`Block` modules. The caches keep
the JAX package's layer-stacked layout (``{"k", "v": (L, B, T, KV, hd),
"pos": (L, B, T)}``), each layer reading and writing its own slice in
place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from repro_torch.comm import Ranks
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (COMPUTE_DTYPE, MLP, Params,
                                       dense_init, embed_lookup, lm_logits,
                                       mlp_apply, padded_vocab, rms_norm)
from repro_torch.models.moe import MoE, moe_apply


def layer_pattern(cfg: ModelConfig) -> List[str]:
    if cfg.family == "moe":
        return ["moe"] * cfg.num_layers
    if cfg.family == "ssm":        # xlstm
        return ["slstm" if cfg.slstm_every and (i + 1) % cfg.slstm_every == 0
                else "mlstm" for i in range(cfg.num_layers)]
    if cfg.family == "hybrid":     # zamba2
        return ["mamba"] * cfg.num_layers
    return ["dense"] * cfg.num_layers


class Block(Params):
    """Pre-norm attention + MLP (``dense``) or + MoE (``moe``): ``ln1``,
    ``attn``, ``ln2``, ``mlp`` or ``moe``, the JAX package's names."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        if kind not in ("dense", "moe"):
            raise NotImplementedError(f"block kind {kind!r} is not ported")
        self.cfg = cfg
        self.add("ln1", (cfg.d_model,), torch.float32, device)
        self.attn = attn.Attention(cfg, device)
        self.add("ln2", (cfg.d_model,), torch.float32, device)
        if kind == "moe":
            self.moe = MoE(cfg, device=device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_gated, device)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.init_weights(generator)
        (self.moe if "moe" in self else self.mlp).init_weights(generator)

    def forward(self, x, q_pos, cache=None, ranks: Optional[Ranks] = None,
                dp_axes: Sequence[str] = ("data",)):
        return _attn_block(self, x, self.cfg, q_pos, cache, ranks, dp_axes)


def _attn_block(params, x, cfg: ModelConfig, q_pos, cache, ranks, dp_axes):
    """One block under ``cfg`` (the caller's: a capacity factor may differ
    from the one the block was built with)."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    a, new_cache = attn.attn_apply(params["attn"], h, cfg, q_pos, cache)
    x = x + a * cfg.residual_scale
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    aux = {}
    if "moe" in params:
        f, aux = moe_apply(params["moe"], h, cfg, ranks, dp_axes)
    else:
        f = mlp_apply(params["mlp"], h, cfg.mlp_gated)
    x = x + f * cfg.residual_scale
    return x, new_cache, aux


class DecoderLM(Params):
    """``embed`` ``(padded_vocab, d)`` (tied readout), ``final_ln``, and
    ``blocks``, one :class:`Block` a layer."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(f"family {cfg.family!r} is not ported")
        self.cfg = cfg
        self.add("embed", (padded_vocab(cfg.vocab), cfg.d_model),
                 COMPUTE_DTYPE, device)
        self.add("final_ln", (cfg.d_model,), torch.float32, device)
        self.blocks = nn.ModuleList(Block(cfg, kind, device)
                                    for kind in layer_pattern(cfg))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """Each tensor drawn in float32 on the parameter's device, one at a
        time, then cast: the model never exists in float32. The embedding
        as ``embed_init`` draws it (padded vocabulary rows zero)."""
        dense_init(self.embed, generator, self.cfg.d_model ** -0.5,
                   self.cfg.vocab)
        self.final_ln.fill_(1.0)
        for block in self.blocks:
            block.init_weights(generator)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> DecoderLM:
    params = DecoderLM(cfg, device)
    params.init_weights(generator)
    return params


def forward(params: DecoderLM, cfg: ModelConfig, x, q_pos,
            caches: Optional[Dict] = None, ranks: Optional[Ranks] = None,
            dp_axes: Sequence[str] = ("data",)):
    """Run the block stack over embeddings x (B,S,d). Returns (hidden
    (B,S,d), caches (written in place) or None, aux dict: the MoE's
    ``moe_aux`` averaged and ``moe_dropped`` summed over the layers)."""
    auxs = []
    for i, block in enumerate(params.blocks):
        c = ({k: v[i] for k, v in caches.items()} if caches is not None
             else None)
        x, _, aux = _attn_block(block, x, cfg, q_pos, c, ranks, dp_axes)
        if aux:
            auxs.append(aux)
    aux_total: Dict[str, Any] = {}
    if auxs:
        aux_total["moe_aux"] = torch.stack(
            [a["moe_aux"].float() for a in auxs]).mean()
        aux_total["moe_dropped"] = torch.stack(
            [torch.as_tensor(a["moe_dropped"]).float() for a in auxs]).sum()
    return x, caches, aux_total


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> Dict[str, torch.Tensor]:
    """The layer-stacked cache of a homogeneous stack."""
    one = attn.init_cache_gqa(cfg, batch, max_len, device=device)
    return {k: v.unsqueeze(0).repeat((cfg.num_layers,) + (1,) * v.dim())
            for k, v in one.items()}


def embed_inputs(params: DecoderLM, cfg: ModelConfig, tokens):
    return embed_lookup(params.embed, tokens)


def lm_forward(params: DecoderLM, cfg: ModelConfig, tokens, q_pos=None,
               caches=None, ranks: Optional[Ranks] = None,
               dp_axes: Sequence[str] = ("data",), last_only: bool = False):
    B, S = tokens.shape
    x = embed_inputs(params, cfg, tokens)
    if q_pos is None:
        q_pos = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x, new_caches, aux = forward(params, cfg, x, q_pos, caches, ranks,
                                 dp_axes)
    if last_only:          # serving prefill: only the next-token logits
        x = x[:, -1:]
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    logits = lm_logits(params.embed, x, cfg.logit_cap, cfg.vocab)
    return logits, new_caches, aux
