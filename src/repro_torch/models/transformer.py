"""Decoder-only LM assembly: block patterns, the layer loop, caches.

Port of ``repro/models/transformer.py``. A *block pattern* maps each layer to a
kind: ``dense`` / ``moe`` (attention, GQA/SWA/MLA, + MLP or MoE),
``mamba`` (Mamba2, zamba2), ``mlstm`` / ``slstm`` (xLSTM), and
``shared_attn``, zamba2's weight-shared attention block, stored once and
applied before every ``attn_every``-th layer. The ``vlm`` family puts
projected image embeddings (``img_proj``) in front of the text.

The JAX package scans homogeneous stacks over stacked parameters;
:func:`forward` is a loop over :class:`Block` modules. With gradients on
and ``cfg.remat`` (the JAX package's ``jax.checkpoint`` of every layer),
each block runs under ``torch.utils.checkpoint`` and is recomputed in the
backward (a MoE layer on a rank grid runs its shuffle and K1 again
there); its aux values are outputs, so the recompute counts nothing
twice. The caches keep the JAX package's
layouts: a homogeneous stack's are layer-stacked (``{"k", "v": (L, B, T,
KV, hd), "pos": (L, B, T)}``, or MLA's latents), each layer reading and
writing its own slice in place; a heterogeneous stack's are a **list** of
per-layer dicts, the shared block's caches (one per application point)
appended in application order. Over process ranks each process holds
its blocks of the caches (``registry.init_caches(..., ranks=)``), and
each layer reads and writes its slice of them as on one process.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.comm import Ranks, model_parallel
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (COMPUTE_DTYPE, MLP, Params,
                                       dense_init, embed_lookup, lm_logits,
                                       mlp_apply, padded_vocab, rms_norm,
                                       round_scalar, sharded_dim,
                                       softmax_xent)
from repro_torch.models.moe import MoE, moe_apply, moe_apply_parallel

ATTN_KINDS = ("dense", "moe", "shared_attn")


def layer_pattern(cfg: ModelConfig) -> List[str]:
    if cfg.family == "moe":
        return ["moe"] * cfg.num_layers
    if cfg.family == "ssm":        # xlstm
        return ["slstm" if cfg.slstm_every and (i + 1) % cfg.slstm_every == 0
                else "mlstm" for i in range(cfg.num_layers)]
    if cfg.family == "hybrid":     # zamba2
        return ["mamba"] * cfg.num_layers
    return ["dense"] * cfg.num_layers


def _shared_attn_points(cfg: ModelConfig) -> List[int]:
    if cfg.family != "hybrid" or not cfg.attn_every:
        return []
    return [i for i in range(cfg.num_layers)
            if (i + 1) % cfg.attn_every == 0]


def homogeneous(cfg: ModelConfig) -> bool:
    """The JAX package scans the stack (stacked parameters and caches):
    one ``dense`` or ``moe`` kind throughout, no shared block."""
    pattern = layer_pattern(cfg)
    return (cfg.scan_layers and len(set(pattern)) == 1
            and pattern[0] in ("dense", "moe") and not _shared_attn_points(cfg))


class Block(Params):
    """One layer under the JAX package's names: pre-norm attention + MLP
    (``dense``, ``shared_attn``) or + MoE (``moe``): ``ln1``, ``attn``,
    ``ln2``, ``mlp`` or ``moe``; ``ln1`` + ``mamba`` (``mamba``); ``ln1``
    + ``cell`` (``mlstm``, ``slstm``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.add("ln1", (cfg.d_model,), torch.float32, device, spec=(None,))
        if kind in ATTN_KINDS:
            self.attn = attn.attention_module(cfg, device)
            self.add("ln2", (cfg.d_model,), torch.float32, device,
                     spec=(None,))
            if kind == "moe":
                self.moe = MoE(cfg, device=device)
            else:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_gated, device)
        elif kind == "mamba":
            self.mamba = ssm.Mamba2(cfg, device)
        elif kind == "mlstm":
            self.cell = ssm.MLSTM(cfg, device)
        elif kind == "slstm":
            self.cell = ssm.SLSTM(cfg, device)
        else:
            raise ValueError(kind)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        self.ln1.fill_(1.0)
        if self.kind in ATTN_KINDS:
            self.ln2.fill_(1.0)
            self.attn.init_weights(generator)
            (self.moe if "moe" in self else self.mlp).init_weights(generator)
        else:
            (self.mamba if self.kind == "mamba" else self.cell).init_weights(
                generator)

    def forward(self, x, q_pos, cache=None, ranks: Optional[Ranks] = None,
                dp_axes: Sequence[str] = ("data",)):
        return apply_block(self, x, self.cfg, self.kind, q_pos, cache, ranks,
                           dp_axes)


def _attn_block(params, x, cfg: ModelConfig, q_pos, cache, ranks, dp_axes):
    """One attention block under ``cfg`` (the caller's: a capacity factor
    may differ from the one the block was built with). Where the process
    holds shards (:func:`repro_torch.comm.model_parallel`) the attention
    (GQA, SWA or MLA) and the MLP or the MoE are model-parallel and the
    norms and the residual see their replicated outputs."""
    tp = model_parallel(ranks)
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, new_cache = attn.mla_apply(params["attn"], h, cfg, q_pos, cache,
                                      ranks=ranks)
    else:
        a, new_cache = attn.attn_apply(params["attn"], h, cfg, q_pos, cache,
                                       ranks=ranks)
    # the JAX package multiplies by the scale rounded to bfloat16 (a
    # weakly typed Python float takes the array's dtype)
    scale = round_scalar(cfg.residual_scale, a.dtype)
    x = x + a * scale
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    aux = {}
    if "moe" in params and tp:
        f, aux = moe_apply_parallel(params["moe"], h, cfg, ranks, dp_axes)
    elif "moe" in params:
        f, aux = moe_apply(params["moe"], h, cfg, ranks, dp_axes)
    else:
        f = mlp_apply(params["mlp"], h, cfg.mlp_gated, ranks)
    x = x + f * scale
    return x, new_cache, aux


#: the recurrent kinds: (parameter name in the block, apply function)
_RECURRENT = {"mamba": ("mamba", ssm.mamba2_apply),
              "mlstm": ("cell", ssm.mlstm_apply),
              "slstm": ("cell", ssm.slstm_apply)}


def apply_block(params, x, cfg: ModelConfig, kind: str, q_pos, cache,
                ranks=None, dp_axes: Sequence[str] = ("data",)):
    """``_apply_block`` of the JAX package: (x, cache, aux). Where the
    process holds shards (:func:`repro_torch.comm.model_parallel`) every
    kind is model-parallel: the attention blocks (zamba2's shared block
    at each of its points too) and the recurrent ones
    (:mod:`repro_torch.models.ssm`)."""
    if kind in ATTN_KINDS:
        return _attn_block(params, x, cfg, q_pos, cache, ranks, dp_axes)
    name, fn = _RECURRENT[kind]
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    y, new_cache = fn(params[name], h, cfg, cache, ranks)
    return x + y, new_cache, {}


class DecoderLM(Params):
    """``embed`` ``(padded_vocab, d)`` (tied readout), ``final_ln``,
    ``blocks``, one :class:`Block` a layer; zamba2's ``shared_attn``
    block once; the ``vlm`` family's ``img_proj`` ``(d, d)``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.add("embed", (padded_vocab(cfg.vocab), cfg.d_model),
                 COMPUTE_DTYPE, device, spec=("model", None))
        self.add("final_ln", (cfg.d_model,), torch.float32, device,
                 spec=(None,))
        self.blocks = nn.ModuleList(Block(cfg, kind, device)
                                    for kind in layer_pattern(cfg))
        if _shared_attn_points(cfg):
            self.shared_attn = Block(cfg, "shared_attn", device)
        if cfg.family == "vlm":
            self.add("img_proj", (cfg.d_model, cfg.d_model), COMPUTE_DTYPE,
                     device, spec=(None, None))

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
        if "shared_attn" in self:
            self.shared_attn.init_weights(generator)
        if "img_proj" in self:
            dense_init(self.img_proj, generator)


def remat_call(remat: bool, fn: Callable, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant)
    when ``remat`` is set and gradients are on: its activations are
    recomputed in the backward instead of kept."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward(params: DecoderLM, cfg: ModelConfig, x, q_pos,
            caches=None, ranks: Optional[Ranks] = None,
            dp_axes: Sequence[str] = ("data",)):
    """Run the block stack over embeddings x (B,S,d). Returns (hidden
    (B,S,d), caches (written in place) or None, aux dict). A homogeneous
    stack averages the MoE's ``moe_aux`` and sums ``moe_dropped`` over the
    layers; a heterogeneous one sums every aux, and applies the shared
    block before layer ``i`` wherever ``(i + 1) % attn_every == 0``, with
    the cache of that application point."""
    aux_total: Dict[str, Any] = {}
    if homogeneous(cfg):
        auxs = []
        for i, block in enumerate(params.blocks):
            c = attn.layer_cache(caches, i) if caches is not None else None
            x, _, aux = remat_call(cfg.remat, _attn_block, block, x, cfg,
                                   q_pos, c, ranks, dp_axes)
            if aux:
                auxs.append(aux)
        if auxs:
            aux_total["moe_aux"] = torch.stack(
                [a["moe_aux"].float() for a in auxs]).mean()
            aux_total["moe_dropped"] = torch.stack(
                [torch.as_tensor(a["moe_dropped"]).float()
                 for a in auxs]).sum()
        return x, caches, aux_total

    shared_pts = set(_shared_attn_points(cfg))
    n_shared = 0
    for i, block in enumerate(params.blocks):
        if i in shared_pts:
            c = (caches[cfg.num_layers + n_shared] if caches is not None
                 else None)
            n_shared += 1
            x, _, _ = remat_call(cfg.remat, apply_block, params.shared_attn,
                                 x, cfg, "shared_attn", q_pos, c, ranks,
                                 dp_axes)
        c = caches[i] if caches is not None else None
        x, _, aux = remat_call(cfg.remat, apply_block, block, x, cfg,
                               block.kind, q_pos, c, ranks, dp_axes)
        for k, v in aux.items():
            aux_total[k] = aux_total.get(k, 0.0) + v
    return x, caches, aux_total


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 device) -> Dict[str, torch.Tensor]:
    if kind in ATTN_KINDS:
        if cfg.attn_type == "mla":
            return attn.init_cache_mla(cfg, batch, max_len, device=device)
        return attn.init_cache_gqa(cfg, batch, max_len, device=device)
    if kind == "mamba":
        return ssm.mamba2_init_cache(cfg, batch, device)
    if kind == "mlstm":
        return ssm.mlstm_init_cache(cfg, batch, device)
    if kind == "slstm":
        return ssm.slstm_init_cache(cfg, batch, device)
    raise ValueError(kind)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """The caches :func:`forward` reads: layer-stacked for a homogeneous
    stack, else a list of per-layer dicts with one cache per shared-block
    application point appended."""
    pattern = layer_pattern(cfg)
    if homogeneous(cfg):
        one = _layer_cache(cfg, pattern[0], batch, max_len, device)
        return {k: v.unsqueeze(0).repeat((cfg.num_layers,) + (1,) * v.dim())
                for k, v in one.items()}
    kinds = pattern + ["shared_attn"] * len(_shared_attn_points(cfg))
    return [_layer_cache(cfg, k, batch, max_len, device) for k in kinds]


def embed_inputs(params: DecoderLM, cfg: ModelConfig, tokens,
                 img_embeds=None, ranks: Optional[Ranks] = None):
    """Token embeddings (vocab-parallel where the process holds shards);
    for the ``vlm`` family ``img_embeds @ img_proj`` in front of them."""
    if model_parallel(ranks) and sharded_dim(params, "embed") != 0:
        raise ValueError(f"a vocab-parallel embedding needs the model axis "
                         f"on its rows: spec {params.specs['embed']}")
    x = embed_lookup(params.embed, tokens, ranks)
    if cfg.family == "vlm" and img_embeds is not None:
        img = img_embeds.to(COMPUTE_DTYPE) @ params.img_proj.to(COMPUTE_DTYPE)
        x = torch.cat([img, x], dim=1)
    return x


def lm_forward(params: DecoderLM, cfg: ModelConfig, tokens, q_pos=None,
               caches=None, ranks: Optional[Ranks] = None,
               dp_axes: Sequence[str] = ("data",), img_embeds=None,
               last_only: bool = False):
    """Logits of the stack over ``tokens`` (and the image embeddings in
    front of them); ``q_pos`` defaults to every embedded position."""
    B = tokens.shape[0]
    x = embed_inputs(params, cfg, tokens, img_embeds, ranks)
    if q_pos is None:
        S = x.shape[1]
        q_pos = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x, new_caches, aux = forward(params, cfg, x, q_pos, caches, ranks,
                                 dp_axes)
    if last_only:          # serving prefill: only the next-token logits
        x = x[:, -1:]
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    logits = lm_logits(params.embed, x, cfg.logit_cap, cfg.vocab, ranks)
    return logits, new_caches, aux


def train_loss(params: DecoderLM, cfg: ModelConfig, batch: Dict,
               ranks: Optional[Ranks] = None,
               dp_axes: Sequence[str] = ("data",), aux_weight: float = 0.01):
    """Mean next-token cross-entropy over ``batch["labels"]`` (masked by
    ``loss_mask`` if given, over ``loss_count`` positions where the
    sharded step gives it, :func:`layers.softmax_xent`; the ``vlm``
    family on its text positions only), plus ``aux_weight`` times the MoE
    load-balance loss. Returns (loss, metrics: the aux values and the
    loss)."""
    img = batch.get("img_embeds")
    logits, _, aux = lm_forward(params, cfg, batch["tokens"], ranks=ranks,
                                dp_axes=dp_axes, img_embeds=img)
    if cfg.family == "vlm" and img is not None:
        logits = logits[:, img.shape[1]:]           # loss on text positions
    loss = softmax_xent(logits, batch["labels"], batch.get("loss_mask"),
                        ranks, batch.get("loss_count"))
    if "moe_aux" in aux:
        loss = loss + aux_weight * aux["moe_aux"]
    return loss, dict(aux, loss=loss)
