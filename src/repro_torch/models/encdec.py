"""Whisper-style encoder-decoder (audio, stub frontend).

Port of ``repro/models/encdec.py``. Inputs are precomputed frame embeddings
``(B, enc_seq, d_model)``; positions are sinusoidal on both sides, as
there. Decoder blocks: causal self-attention (cached at decode) +
cross-attention over the encoder output + MLP. The cross K/V are
recomputed from ``enc_out`` in every call of :func:`decode_stack`, as the
JAX package does. The decoder's self-attention caches are layer-stacked
(``{"k", "v": (L, B, T, KV, hd), "pos": (L, B, T)}``), written in place.
With gradients on and ``cfg.remat``, every encoder and decoder layer is
recomputed in the backward (the JAX package's ``jax.checkpoint`` of its
scan bodies).

Over process ranks that hold shards
(:func:`repro_torch.comm.model_parallel`) the training forward is
model-parallel: the embedding and the readout vocab-parallel, the MLPs
column/row-parallel, the attentions in the branch their specs give
(:func:`attention.tp_layout`; Whisper's 12 heads against ``tp_size`` 16
take the sequence layout: each rank attends from its block of query rows,
over every encoder position in the cross-attention). The encoder output
enters the decoder once, through ``copy_to``: each rank's cross keys and
values read all of it, but only for its own query rows or heads, so the
backward sums its gradient over ``model`` before the encoder sees it.
Serving over process ranks runs the same branches over this process's
block of the decoder's self-attention caches
(:func:`repro_torch.models.attention.attn_apply`, without rope), the
cross keys and values recomputed from the encoder output every call,
as the JAX package's ``decode_step`` does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.comm import model_parallel
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (COMPUTE_DTYPE, MLP, Params,
                                       dense_init, embed_lookup,
                                       enter_parallel, lm_logits, mlp_apply,
                                       padded_vocab, parallel_product,
                                       rms_norm, sinusoid_at,
                                       sinusoid_positions, softmax_xent)
from repro_torch.models.transformer import remat_call


class EncBlock(Params):
    """``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.add("ln1", (cfg.d_model,), torch.float32, device, spec=(None,))
        self.attn = attn.Attention(cfg, device)
        self.add("ln2", (cfg.d_model,), torch.float32, device, spec=(None,))
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_gated, device)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.init_weights(generator)
        self.mlp.init_weights(generator)


class DecBlock(Params):
    """``ln1``, ``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``,
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.add("ln1", (cfg.d_model,), torch.float32, device, spec=(None,))
        self.self_attn = attn.Attention(cfg, device)
        self.add("ln_x", (cfg.d_model,), torch.float32, device, spec=(None,))
        self.cross_attn = attn.Attention(cfg, device)
        self.add("ln2", (cfg.d_model,), torch.float32, device, spec=(None,))
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_gated, device)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        for name in ("ln1", "ln_x", "ln2"):
            self[name].fill_(1.0)
        self.self_attn.init_weights(generator)
        self.cross_attn.init_weights(generator)
        self.mlp.init_weights(generator)


class EncDec(Params):
    """``embed`` ``(padded_vocab, d)`` (tied readout), ``enc_blocks``,
    ``dec_blocks``, ``enc_ln`` and ``final_ln``, the JAX package's
    names."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.add("embed", (padded_vocab(cfg.vocab), cfg.d_model),
                 COMPUTE_DTYPE, device, spec=("model", None))
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, device)
                                        for _ in range(cfg.enc_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device)
                                        for _ in range(cfg.num_layers))
        self.add("enc_ln", (cfg.d_model,), torch.float32, device, spec=(None,))
        self.add("final_ln", (cfg.d_model,), torch.float32, device,
                 spec=(None,))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        dense_init(self.embed, generator, self.cfg.d_model ** -0.5,
                   self.cfg.vocab)
        for block in (*self.enc_blocks, *self.dec_blocks):
            block.init_weights(generator)
        self.enc_ln.fill_(1.0)
        self.final_ln.fill_(1.0)


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=device).expand(b, t)


def encode(params: EncDec, cfg: ModelConfig, frames,
           ranks=None) -> torch.Tensor:
    """frames: (B, T_enc, d) stub embeddings -> encoder hidden (B, T_enc,
    d), bfloat16 (replicated over ``model`` where ``ranks`` hold
    shards)."""
    B, T, _ = frames.shape
    x = frames.to(COMPUTE_DTYPE) + sinusoid_positions(
        T, cfg.d_model, frames.device).to(COMPUTE_DTYPE)
    pos = _positions(B, T, frames.device)
    for bp in params.enc_blocks:
        x = remat_call(cfg.remat, _enc_layer, bp, x, cfg, pos, ranks)
    return rms_norm(x, params.enc_ln, cfg.norm_eps)


def _enc_layer(bp: EncBlock, x, cfg: ModelConfig, pos, ranks=None):
    a, _ = attn.attn_apply(bp.attn, rms_norm(x, bp.ln1, cfg.norm_eps),
                           cfg, pos, causal=False, rope=False, ranks=ranks)
    x = x + a
    f = mlp_apply(bp.mlp, rms_norm(x, bp.ln2, cfg.norm_eps), cfg.mlp_gated,
                  ranks)
    return x + f


def _cross_kv(bp: DecBlock, cfg: ModelConfig, enc_out, ranks=None):
    """The cross-attention's keys, values and positions. Where ``ranks``
    hold shards ``enc_out`` is :func:`decode_stack`'s float32 entry, and
    the products are this rank's (its KV heads in the heads layout)."""
    B, T, _ = enc_out.shape
    hd = cfg.hd
    if model_parallel(ranks):
        k = parallel_product(enc_out, bp.cross_attn.wk)
        v = parallel_product(enc_out, bp.cross_attn.wv)
    else:
        k = enc_out @ bp.cross_attn.wk.to(COMPUTE_DTYPE)
        v = enc_out @ bp.cross_attn.wv.to(COMPUTE_DTYPE)
    return (k.reshape(B, T, -1, hd), v.reshape(B, T, -1, hd),
            _positions(B, T, enc_out.device))


def decode_stack(params: EncDec, cfg: ModelConfig, tokens, enc_out,
                 q_pos=None, caches: Optional[Dict] = None, ranks=None):
    """Decoder over tokens; ``enc_out`` precomputed. ``caches``: the
    stacked self-attention caches (decode, written in place) or None
    (teacher forcing). ``ranks`` holding shards: the model-parallel
    decoder, over a full forward or this process's blocks of the caches,
    the logits this rank's vocabulary columns. Returns (logits at every
    position, caches)."""
    B, S = tokens.shape
    tp = model_parallel(ranks)
    x = embed_lookup(params.embed, tokens, ranks)
    if q_pos is None:
        q_pos = _positions(B, S, x.device)
    x = x + sinusoid_at(q_pos, cfg.d_model).to(COMPUTE_DTYPE)
    if tp:
        # once for every layer's cross keys and values: the backward sums
        # the encoder output's gradient over model
        enc_out = enter_parallel(ranks, enc_out)
    for i, bp in enumerate(params.dec_blocks):
        c = ({k: v[i] for k, v in caches.items()} if caches is not None
             else None)
        x = remat_call(cfg.remat, _dec_layer, bp, x, cfg, q_pos, c, enc_out,
                       ranks)
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    logits = lm_logits(params.embed, x, cfg.logit_cap, cfg.vocab, ranks)
    return logits, caches


def _dec_layer(bp: DecBlock, x, cfg: ModelConfig, q_pos, cache, enc_out,
               ranks=None):
    a, _ = attn.attn_apply(bp.self_attn, rms_norm(x, bp.ln1, cfg.norm_eps),
                           cfg, q_pos, cache=cache, causal=True, rope=False,
                           ranks=ranks)
    x = x + a
    xa, _ = attn.attn_apply(bp.cross_attn, rms_norm(x, bp.ln_x, cfg.norm_eps),
                            cfg, q_pos,
                            cross_kv=_cross_kv(bp, cfg, enc_out, ranks),
                            rope=False, ranks=ranks)
    x = x + xa
    f = mlp_apply(bp.mlp, rms_norm(x, bp.ln2, cfg.norm_eps), cfg.mlp_gated,
                  ranks)
    return x + f


def train_loss(params: EncDec, cfg: ModelConfig, batch: Dict, ranks=None):
    """Teacher-forced cross-entropy of the decoder over ``frames`` and
    ``tokens`` against ``labels`` (masked by ``loss_mask`` if given, over
    ``loss_count`` positions where the sharded step gives it). ``ranks``
    holding shards: the model-parallel forward of the module docstring.
    Returns (loss, {"loss": loss})."""
    enc_out = encode(params, cfg, batch["frames"], ranks)
    logits, _ = decode_stack(params, cfg, batch["tokens"], enc_out,
                             ranks=ranks)
    loss = softmax_xent(logits, batch["labels"], batch.get("loss_mask"),
                        ranks, batch.get("loss_count"))
    return loss, {"loss": loss}


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> Dict[str, torch.Tensor]:
    one = attn.init_cache_gqa(cfg, batch, max_len, device=device)
    return {k: v.unsqueeze(0).repeat((cfg.num_layers,) + (1,) * v.dim())
            for k, v in one.items()}
