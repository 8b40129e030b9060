"""Attention: GQA/MQA (full causal) and sliding-window (SWA), with the
KV-cache decode path.

Port of the GQA/SWA part of ``repro/models/attention.py`` (MLA waits, see
``ROADMAP.md``). Cache contract, as there: ``{"k", "v": (B, T_cache, KV,
hd), "pos": (B, T_cache) int32}``, ``pos`` the absolute position stored
in each slot (-1 = empty); SWA keeps a **ring buffer** of ``T_cache =
window`` slots. The port writes a cache **in place** and returns it.
The JAX package's ``_seq_shard`` is a sharding constraint; on stacked
ranks it has nothing to do and is not ported.

Scores follow the JAX package's rounding: its einsums take bfloat16
operands and accumulate and return float32 (``preferred_element_type``),
so here the bfloat16 operands are widened to float32 and multiplied in
float32 (a bfloat16 product would round the scores). The probabilities
are rounded to bfloat16 before the second product, as there. No fused
attention call is used: it rounds differently.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, Params, apply_rope,
                                       dense_init, rms_norm)

NEG_INF = -1e30


class Attention(Params):
    """``wq`` ``(d, H * hd)``, ``wk``/``wv`` ``(d, KV * hd)``, ``wo``
    ``(H * hd, d)``; with ``qk_norm`` also ``q_norm``/``k_norm``
    ``(hd,)`` float32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.attn_type == "mla":
            raise NotImplementedError(
                "MLA attention (minicpm3) is not ported yet: ROADMAP.md "
                "queue 1, item 3 (MLA)")
        self.cfg = cfg
        hd, d = cfg.hd, cfg.d_model
        self.add("wq", (d, cfg.n_heads * hd), COMPUTE_DTYPE, device)
        self.add("wk", (d, cfg.n_kv_heads * hd), COMPUTE_DTYPE, device)
        self.add("wv", (d, cfg.n_kv_heads * hd), COMPUTE_DTYPE, device)
        self.add("wo", (cfg.n_heads * hd, d), COMPUTE_DTYPE, device)
        if cfg.qk_norm:
            self.add("q_norm", (hd,), torch.float32, device)
            self.add("k_norm", (hd,), torch.float32, device)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        for name in ("wq", "wk", "wv", "wo"):
            dense_init(self[name], generator)
        if self.cfg.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)

    def forward(self, x, q_pos, cache: Optional[Dict] = None,
                causal: bool = True):
        return attn_apply(self, x, self.cfg, q_pos, cache, causal)


def heads_shardable(cfg: ModelConfig) -> bool:
    """True when the JAX package shards attention weights by head instead
    of adding sequence-parallel constraints (a sharding decision only: on
    stacked ranks both compute the same)."""
    return cfg.n_heads % cfg.tp_size == 0


def _sdpa(q, k, v, q_pos, kv_pos, *, causal: bool, window: Optional[int],
          scale: float):
    """q: (B,S,H,hd); k,v: (B,T,KV,*); q_pos (B,S); kv_pos (B,T).
    Grouped-query attention with a float32 softmax; masks built from
    positions, so the same code serves prefill and ring-buffer decode."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.to(COMPUTE_DTYPE).float().reshape(B, S, KV, G, hd)
    kf = k.to(COMPUTE_DTYPE).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, kf) * scale
    mask = kv_pos[:, None, :] >= 0                         # slot occupied
    if causal:
        mask = mask & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(COMPUTE_DTYPE)
    out = torch.einsum("bkgst,btkh->bskgh", probs.float(),
                       v.to(COMPUTE_DTYPE).float())
    return out.reshape(B, S, H, v.shape[-1]).to(COMPUTE_DTYPE)


def _cache_update(cache: Dict, new_k, new_v, q_pos) -> Dict:
    """Write new entries into the (possibly ring) cache, in place.
    new_k/new_v: (B, S_new, KV, hd); q_pos: (B, S_new) consecutive
    absolute positions. A ring of T slots keeps only the last T of them,
    so only those are written: no slot is written twice."""
    T = cache["k"].shape[1]
    if q_pos.shape[1] > T:
        new_k, new_v, q_pos = new_k[:, -T:], new_v[:, -T:], q_pos[:, -T:]
    slots = (q_pos % T).long()
    b_idx = torch.arange(new_k.shape[0], device=slots.device)[:, None]
    b_idx = b_idx.expand_as(slots)
    cache["k"][b_idx, slots] = new_k.to(cache["k"].dtype)
    cache["v"][b_idx, slots] = new_v.to(cache["v"].dtype)
    cache["pos"][b_idx, slots] = q_pos.to(torch.int32)
    return cache


def attn_apply(params, x, cfg: ModelConfig, q_pos,
               cache: Optional[Dict] = None, causal: bool = True):
    """Self-attention over x (B,S,d). ``cache=None``: keys and values
    from x itself (prefill or a full forward). A cache: write the new
    entries, then attend over the whole cache (decode, or prefill into a
    cache). Returns (out, cache)."""
    B, S, _ = x.shape
    hd = cfg.hd
    x = x.to(COMPUTE_DTYPE)
    q = (x @ params["wq"].to(COMPUTE_DTYPE)).reshape(B, S, cfg.n_heads, hd)
    k = (x @ params["wk"].to(COMPUTE_DTYPE)).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ params["wv"].to(COMPUTE_DTYPE)).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)

    window = cfg.window if cfg.attn_type == "swa" else None
    scale = hd ** -0.5
    if cache is None:
        out = _sdpa(q, k, v, q_pos, q_pos, causal=causal, window=window,
                    scale=scale)
    else:
        cache = _cache_update(cache, k, v, q_pos)
        out = _sdpa(q, cache["k"], cache["v"], q_pos, cache["pos"],
                    causal=causal, window=window, scale=scale)
    out = out.reshape(B, S, cfg.n_heads * hd) @ params["wo"].to(COMPUTE_DTYPE)
    return out, cache


def init_cache_gqa(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=COMPUTE_DTYPE, device=None) -> Dict:
    T = min(max_len, cfg.window) if cfg.attn_type == "swa" else max_len
    return {
        "k": torch.zeros((batch, T, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, T, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, T), -1, dtype=torch.int32, device=device),
    }
