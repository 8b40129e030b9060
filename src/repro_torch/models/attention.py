"""Attention: GQA/MQA (full causal), sliding-window (SWA), MLA
(multi-head latent attention) and cross-attention, with the KV-cache
decode paths.

Port of ``repro/models/attention.py``. Cache contracts, as there:

- GQA: ``{"k", "v": (B, T_cache, KV, hd), "pos": (B, T_cache) int32}``,
  ``pos`` the absolute position stored in each slot (-1 = empty); SWA
  keeps a **ring buffer** of ``T_cache = window`` slots.
- MLA: ``{"ckv": (B, T, kv_rank), "k_rope": (B, T, rope_dim), "pos":
  (B, T)}``, the latent cache; ``T = max_len`` (no ring).

The port writes a cache **in place** and returns it.

Over process ranks that hold shards
(:func:`repro_torch.comm.model_parallel`), :func:`attn_apply` takes the
branch its weights' specs give it (:func:`tp_layout`, the JAX package's
rules at ``tp_size``): the heads sharded (``wk``/``wv`` too, or
replicated when there is one KV head), ``wo`` row-parallel with
``reduce_from``; the split-dim keys and values of ``1 < KV < model``
(``wk``/``wv`` column-split, so that a rank holds part of one KV head's
dimensions), gathered whole over ``model`` before ``k_norm`` and rope;
or, where the heads do not divide ``tp_size``, every weight replicated
and the JAX package's ``_seq_shard``: each rank attends from its block
of query rows to every key, and ``gather_from`` joins the rows. Rope is
optional (the enc-dec's self-attention runs without it), and
cross-attention attends from the same query heads or rows over every
encoder position, its keys and values the rank's products of the
encoder output. On stacked ranks ``_seq_shard`` is a sharding
constraint with nothing to do. :func:`mla_apply` over such ranks shards
MLA's heads as ``_mla_init``'s specs do (``wq_up``, ``wk_up``, ``wv_up``
by columns, ``wo`` by rows): the down projections, their norms and the
decoupled rope key run replicated, and the latents enter the heads'
products through one ``copy_to``, so the replicated weights take their
whole gradient on every rank; where ``model`` does not divide the
heads, the column blocks end inside heads, and an ``exchange`` after
each column-parallel product moves the pieces of each head to the one
rank that attends it (:func:`mla_pieces`), the inverse one before
``wo``. Both take this process's block of a cache over ranks (prefill
and decode: :func:`_attn_model_parallel`, :func:`_mla_model_parallel`),
its data rows and the KV heads the JAX package's ``cache_specs`` give
it.

A batch of one (not sliding-window) shards the cache's time axis over
the dp axes (the JAX package's ``shard_t``): a :class:`TimeBlock`, its
row replicated. Each new position is written only into the block that
holds its slot, and each rank scores its block; the probabilities are
the ones the whole cache gives (:func:`_softmax`: the row max a ``pmax``
and the sum of ``exp`` a ``psum`` over those axes, the probabilities
then rounded to bfloat16 as ever), and the blocks' float32 ``probs @ v``
is summed over them before it is rounded: three collectives an attention
layer a call, for GQA in either layout and for MLA's latent cache alike.

Scores follow the JAX package's rounding: its einsums take bfloat16
operands and accumulate and return float32 (``preferred_element_type``),
so here the bfloat16 operands are widened to float32 and multiplied in
float32 (a bfloat16 product would round the scores). The probabilities
are rounded to bfloat16 before the second product, as there. No fused
attention call is used: it rounds differently.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.comm import (axis_position, copy_to, exchange,
                              gather_from, gather_heads, model_parallel,
                              reduce_from)
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, Params, apply_rope,
                                       dense_init, enter_parallel,
                                       parallel_product, rms_norm,
                                       row_parallel, sharded_dim)

NEG_INF = -1e30


class Attention(Params):
    """``wq`` ``(d, H * hd)``, ``wk``/``wv`` ``(d, KV * hd)``, ``wo``
    ``(H * hd, d)``; with ``qk_norm`` also ``q_norm``/``k_norm``
    ``(hd,)`` float32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd, d = cfg.hd, cfg.d_model
        # the JAX package's rules: heads over "model" when they divide
        # its size (kv heads replicated when there is one), else every
        # projection replicated
        if cfg.n_heads % cfg.tp_size == 0:
            qs = wos = "model"
            kvs = None if cfg.n_kv_heads == 1 else "model"
        else:
            qs = kvs = wos = None
        self.add("wq", (d, cfg.n_heads * hd), COMPUTE_DTYPE, device,
                 spec=(None, qs))
        self.add("wk", (d, cfg.n_kv_heads * hd), COMPUTE_DTYPE, device,
                 spec=(None, kvs))
        self.add("wv", (d, cfg.n_kv_heads * hd), COMPUTE_DTYPE, device,
                 spec=(None, kvs))
        self.add("wo", (cfg.n_heads * hd, d), COMPUTE_DTYPE, device,
                 spec=(wos, None))
        if cfg.qk_norm:
            self.add("q_norm", (hd,), torch.float32, device, spec=(None,))
            self.add("k_norm", (hd,), torch.float32, device, spec=(None,))

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


class MLA(Params):
    """Multi-head latent attention under ``_mla_init``'s names:
    ``wq_down`` ``(d, q_rank)``, ``q_norm`` ``(q_rank,)``, ``wq_up``
    ``(q_rank, H * (nope + rope))``, ``wkv_down`` ``(d, kv_rank +
    rope)``, ``kv_norm`` ``(kv_rank,)``, ``wk_up`` ``(kv_rank, H *
    nope)``, ``wv_up`` ``(kv_rank, H * v)``, ``wo`` ``(H * v, d)``; the
    norms float32, the matrices bfloat16."""

    MATRICES = ("wq_down", "wq_up", "wkv_down", "wk_up", "wv_up", "wo")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, d = cfg.n_heads, cfg.d_model
        qd = cfg.qk_nope_dim + cfg.qk_rope_dim
        self.add("wq_down", (d, cfg.q_lora_rank), COMPUTE_DTYPE, device,
                 spec=(None, None))
        self.add("q_norm", (cfg.q_lora_rank,), torch.float32, device,
                 spec=(None,))
        self.add("wq_up", (cfg.q_lora_rank, H * qd), COMPUTE_DTYPE, device,
                 spec=(None, "model"))
        self.add("wkv_down", (d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                 COMPUTE_DTYPE, device, spec=(None, None))
        self.add("kv_norm", (cfg.kv_lora_rank,), torch.float32, device,
                 spec=(None,))
        self.add("wk_up", (cfg.kv_lora_rank, H * cfg.qk_nope_dim),
                 COMPUTE_DTYPE, device, spec=(None, "model"))
        self.add("wv_up", (cfg.kv_lora_rank, H * cfg.v_head_dim),
                 COMPUTE_DTYPE, device, spec=(None, "model"))
        self.add("wo", (H * cfg.v_head_dim, d), COMPUTE_DTYPE, device,
                 spec=("model", None))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        for name in self.MATRICES:
            dense_init(self[name], generator)
        self.q_norm.fill_(1.0)
        self.kv_norm.fill_(1.0)

    def forward(self, x, q_pos, cache: Optional[Dict] = None,
                absorb: bool = False):
        return mla_apply(self, x, self.cfg, q_pos, cache, absorb)


def attention_module(cfg: ModelConfig, device=None) -> Params:
    """The attention a block of ``cfg`` holds: :class:`MLA` or
    :class:`Attention` (``attn_init``'s dispatch)."""
    return MLA(cfg, device) if cfg.attn_type == "mla" \
        else Attention(cfg, device)


def heads_shardable(cfg: ModelConfig) -> bool:
    """True when the JAX package shards attention weights by head instead
    of adding sequence-parallel constraints (a sharding decision only: on
    stacked ranks both compute the same)."""
    return cfg.n_heads % cfg.tp_size == 0


class TimeBlock(dict):
    """One process's block of an attention layer's cache whose time axis
    the specs shard over ``axes`` (a batch of one, not sliding-window):
    the rank at ``i`` along ``axes`` holds slots ``[i T_b, (i + 1) T_b)``
    of the whole cache, ``T_b`` the block's length. The leaves are the
    cache's as ever (``registry.init_caches(..., ranks=)`` makes it)."""

    def __init__(self, leaves=(), axes=()):
        super().__init__(leaves)
        self.axes = tuple(axes)


def layer_cache(caches: Dict, i: int) -> Dict:
    """Layer ``i`` of a layer-stacked cache (views of its leaves), a
    :class:`TimeBlock` where the stack's is one."""
    out = {k: v[i] for k, v in caches.items()}
    return TimeBlock(out, caches.axes) if isinstance(caches, TimeBlock) \
        else out


def _block_start(cache: Dict, ranks) -> Optional[int]:
    """The first slot of a :class:`TimeBlock` in the whole cache; None for
    a whole cache (or a ring)."""
    if not isinstance(cache, TimeBlock):
        return None
    return axis_position(ranks, cache.axes) * cache["pos"].shape[1]


def _time_axes(cache: Optional[Dict]):
    """The axes a cache's time blocks lie over (None: a whole cache)."""
    return cache.axes if isinstance(cache, TimeBlock) else None


def _over_blocks(ranks, op, x: torch.Tensor, axes) -> torch.Tensor:
    """``ranks.psum`` or ``pmax`` of a process's ``x`` over ``axes``."""
    return op(x[None], axes).reshape(x.shape)


def _softmax(scores, ranks=None, axes=None):
    """``softmax`` over the last dimension; over a time-sharded cache
    (``axes``), over every block's slots: the row max a ``pmax`` and the
    sum of ``exp`` a ``psum`` over ``axes``. A block with no occupied
    slot (every score ``NEG_INF``) gives exactly zero weight."""
    if axes is None:
        return torch.softmax(scores, dim=-1)
    top = _over_blocks(ranks, ranks.pmax,
                       scores.amax(dim=-1, keepdim=True), axes)
    e = torch.exp(scores - top)
    return e / _over_blocks(ranks, ranks.psum, e.sum(dim=-1, keepdim=True),
                            axes)


def _sum_blocks(out, ranks=None, axes=None):
    """A time block's float32 ``probs @ v`` summed over ``axes`` (a whole
    cache's as it is)."""
    return out if axes is None else _over_blocks(ranks, ranks.psum, out,
                                                 axes)


def _sdpa(q, k, v, q_pos, kv_pos, *, causal: bool, window: Optional[int],
          scale: float, ranks=None, axes=None):
    """q: (B,S,H,hd); k,v: (B,T,KV,*); q_pos (B,S); kv_pos (B,T).
    Grouped-query attention with a float32 softmax; masks built from
    positions, so the same code serves prefill and ring-buffer decode.
    ``axes``: ``k`` and ``v`` are a time block of a cache sharded over
    them (:func:`_softmax`, :func:`_sum_blocks`)."""
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
    probs = _softmax(scores, ranks, axes).to(COMPUTE_DTYPE)
    out = torch.einsum("bkgst,btkh->bskgh", probs.float(),
                       v.to(COMPUTE_DTYPE).float())
    out = _sum_blocks(out, ranks, axes)
    return out.reshape(B, S, H, v.shape[-1]).to(COMPUTE_DTYPE)


def _write_slots(q_pos, T: int, start: Optional[int]):
    """Where a cache block of ``T`` slots takes the new positions
    ``q_pos`` (B, S), consecutive in each row: ``(rows, slots, src,
    kept)``. A ring or a whole cache (``start`` None): every position at
    slot ``p % T``, ``src`` and ``kept`` None. A time block starting at
    slot ``start`` of the whole cache: a window of ``min(S, T)`` slots a
    row that holds every new position falling in the block, slot ``j``
    taking new position ``src[b, j]`` where ``kept`` and keeping its
    value elsewhere; no slot twice, and no shape depends on the positions
    (a traced program's cannot)."""
    B, S = q_pos.shape
    b_idx = torch.arange(B, device=q_pos.device)[:, None]
    if start is None:
        return b_idx.expand_as(q_pos), (q_pos % T).long(), None, None
    W = min(S, T)
    first = q_pos[:, :1].long()
    slots = (first - start).clamp(0, T - W) + torch.arange(
        W, device=q_pos.device)
    src = slots + start - first
    kept = (src >= 0) & (src < S)
    return b_idx.expand_as(slots), slots, src.clamp(0, S - 1), kept


def _write(cache: Dict, key: str, rows, slots, src, kept, new) -> None:
    """``new`` (B, S, ...) into ``cache[key]`` at :func:`_write_slots`'
    ``rows, slots`` (a time block's kept positions only)."""
    new = new.to(cache[key].dtype)
    if src is not None:
        mask = kept.reshape(kept.shape + (1,) * (new.dim() - 2))
        new = torch.where(mask, new[rows, src], cache[key][rows, slots])
    cache[key][rows, slots] = new


def _cache_update(cache: Dict, new_k, new_v, q_pos,
                  start: Optional[int] = None) -> Dict:
    """Write new entries into the (possibly ring) cache, in place.
    new_k/new_v: (B, S_new, KV, hd); q_pos: (B, S_new) consecutive
    absolute positions. A ring of T slots keeps only the last T of them,
    so only those are written: no slot is written twice. ``start``: the
    cache is a time block from that slot (:func:`_write_slots`)."""
    T = cache["k"].shape[1]
    if start is None and q_pos.shape[1] > T:
        new_k, new_v, q_pos = new_k[:, -T:], new_v[:, -T:], q_pos[:, -T:]
    at = _write_slots(q_pos, T, start)
    _write(cache, "k", *at, new_k)
    _write(cache, "v", *at, new_v)
    _write(cache, "pos", *at, q_pos)
    return cache


def tp_layout(cfg: ModelConfig, params: Params, model: int) -> str:
    """The model-parallel branch of an attention whose weights carry
    ``params.specs``, on a ``model`` axis of ``model`` ranks:

    - ``"heads"``: a rank holds ``H / model`` query heads and the ``KV /
      model`` KV heads they use, or every KV head where ``wk``/``wv``
      are replicated (``KV == 1``); MLA: ``H / model`` heads of
      ``wq_up``, ``wk_up``, ``wv_up`` and ``wo``;
    - ``"split_kv"``: ``wk``/``wv`` column-split with ``1 < KV < model``
      (TinyLlama's 4 KV heads at ``model`` = 8 or 16): a rank holds
      ``KV hd / model`` columns of one KV head, gathered whole before
      ``k_norm`` and rope (:func:`gather_heads`); ``KV`` must divide
      ``model``, so that the rank's ``H / model`` query heads all use one
      KV head (:func:`kv_head_of_rank`);
    - ``"split_heads"`` (MLA): heads that ``model`` does not divide
      (MiniCPM3's 40 at ``model`` = 16): each weight's column block ends
      inside a head, and each head is attended by one owner
      (:func:`mla_pieces`);
    - ``"sequence"``: every weight replicated (``_seq_shard``).

    Anything else raises ``ValueError``, naming the shape."""
    if cfg.attn_type == "mla":
        want = {n: (1 if n in ("wq_up", "wk_up", "wv_up") else
                    0 if n == "wo" else None) for n in params.specs}
        got = {n: sharded_dim(params, n) for n in params.specs}
        if got != want:
            raise ValueError(f"{cfg.arch_id}: MLA specs {params.specs} are "
                             f"not column/row-parallel by head")
        if cfg.n_heads % model == 0:
            return "heads"
        for name, width in _mla_widths(cfg).items():
            if cfg.n_heads * width % model:
                raise ValueError(
                    f"{cfg.arch_id}: {cfg.n_heads} MLA heads do not split "
                    f"over {model} model ranks: {name}'s {cfg.n_heads} x "
                    f"{width} columns do not divide into {model} blocks")
        return "split_heads"
    q, kv = sharded_dim(params, "wq"), sharded_dim(params, "wk")
    if q is None:
        if kv is not None or sharded_dim(params, "wo") is not None:
            raise ValueError(f"{cfg.arch_id}: attention specs {params.specs}"
                             f" shard some weights but not the queries")
        return "sequence"
    if q != 1 or sharded_dim(params, "wo") != 0 or kv not in (None, 1):
        raise ValueError(f"{cfg.arch_id}: attention specs {params.specs} "
                         f"are not column/row-parallel by head")
    if cfg.n_heads % model:
        raise ValueError(f"{cfg.arch_id}: {cfg.n_heads} query heads do not "
                         f"split over {model} model ranks")
    if kv is None or cfg.n_kv_heads % model == 0:
        return "heads"
    if model % cfg.n_kv_heads:
        raise ValueError(
            f"{cfg.arch_id}: split-dim KV columns ({cfg.n_kv_heads} KV heads "
            f"over {model} model ranks) neither split whole over the ranks "
            f"nor divide them: a rank's {cfg.n_heads // model} query heads "
            f"would use parts of two KV heads")
    return "split_kv"


def kv_head_of_rank(n_heads: int, n_kv_heads: int, model: int,
                    rank: int) -> int:
    """The KV head the query heads of the rank at ``rank`` along a
    ``model`` axis of ``model`` ranks use in the ``"split_kv"`` layout:
    its first query head's, ``(rank H / model) // (H / KV)``."""
    return rank * (n_heads // model) // (n_heads // n_kv_heads)


def _mla_widths(cfg: ModelConfig) -> Dict[str, int]:
    """The columns a head has in each of MLA's column-parallel weights
    (``wo``'s rows a head are ``wv_up``'s columns)."""
    return {"wq_up": cfg.qk_nope_dim + cfg.qk_rope_dim,
            "wk_up": cfg.qk_nope_dim, "wv_up": cfg.v_head_dim}


def mla_owned_heads(n_heads: int, model: int, rank: int) -> range:
    """The heads the rank at ``rank`` attends in the ``"split_heads"``
    layout: those whose first column lies in its block, ``owner(h) =
    floor(h model / H)``, the same in every weight (each holds ``H /
    model`` heads' columns a rank)."""
    return range(-(-rank * n_heads // model),
                 -(-(rank + 1) * n_heads // model))


@functools.lru_cache(maxsize=None)
def mla_pieces(n_heads: int, width: int, model: int
               ) -> Tuple[Tuple[Tuple[int, ...], ...],
                          Tuple[Tuple[int, ...], ...]]:
    """The piece table of one MLA weight whose ``n_heads`` heads of
    ``width`` columns each are split by column over ``model`` ranks:
    ``(send, recv)``, ``send[r][j]`` the columns of rank ``r``'s block
    that belong to heads rank ``j`` owns (:func:`mla_owned_heads`),
    ``recv[j][r] = send[r][j]``. A rank's block sends its consecutive
    pieces to their owners in rank order, and an owner's received pieces
    join in rank order into its heads' columns, in order. The columns
    divide into ``model`` blocks (:func:`tp_layout` checks)."""
    c = n_heads * width // model
    owned = [mla_owned_heads(n_heads, model, j) for j in range(model)]

    def overlap(r: int, j: int) -> int:
        lo = max(r * c, owned[j].start * width)
        hi = min((r + 1) * c, owned[j].stop * width)
        return max(hi - lo, 0)
    send = tuple(tuple(overlap(r, j) for j in range(model))
                 for r in range(model))
    recv = tuple(tuple(send[r][j] for r in range(model))
                 for j in range(model))
    return send, recv


def _cache_heads(cfg: ModelConfig, cache: Dict, layout: str,
                 kv_heads: int) -> str:
    """How a rank holding ``kv_heads`` KV heads meets its layer's cache
    block, in any of :func:`tp_layout`'s three GQA layouts: ``"own"``
    (the block holds exactly the rank's heads: the cache shards them as
    ``wk`` does, or both hold every head, as the sequence layout and the
    split-dim keys gathered whole do) or ``"gather"`` (the heads layout,
    the cache holding every KV head while ``wk``/``wv`` shard them: the
    JAX package's ``_kv_spec`` keeps KV heads that do not divide 16
    whole). A block of other heads raises."""
    held = cache["k"].shape[2]
    if held == kv_heads:
        return "own"
    if layout == "heads" and held == cfg.n_kv_heads:
        return "gather"
    raise ValueError(f"{cfg.arch_id}: a cache block of {held} KV heads "
                     f"against {kv_heads} held by the rank in the "
                     f"{layout} layout")


def _attn_model_parallel(params, x, cfg: ModelConfig, q_pos, ranks,
                         causal: bool, rope: bool = True,
                         cross_kv: Optional[Tuple] = None,
                         cache: Optional[Dict] = None):
    """Self- or cross-attention over the replicated ``x`` (B, S, d) on a
    process holding its shards (see the module docstring); the output is
    replicated. ``cross_kv=(k, v, kv_pos)``: keys and values this rank
    computed from the encoder output (its KV heads in the heads layout,
    every one in the sequence layout), which entered through
    ``copy_to`` (:func:`repro_torch.models.encdec.decode_stack`), so
    their gradients are summed over ``model`` there.

    ``cache``: this process's block of the layer's cache (its data rows,
    every slot or a :class:`TimeBlock`'s; the KV heads its spec gives
    it), written in place with the new positions, then attended over
    (the blocks of a time-sharded cache combined over its axes). Heads
    layout: the rank writes
    its KV heads where the block holds just those; where the block holds
    every KV head and ``wk``/``wv`` shard them, the new keys and values
    are gathered over ``model`` (one ``all_gather``), every head written
    and the rank's own read back. Split-dim KV layout: the rank's
    columns of the new keys and values are gathered whole over ``model``
    (:func:`repro_torch.comm.gather_heads`, one ``all_gather``; its
    backward a ``reduce_scatter``) before ``k_norm`` and rope, every
    head written into the block, which holds every KV head, and the
    rank's query heads attend the one KV head they use
    (:func:`kv_head_of_rank`). Sequence layout: every rank projects
    and writes the keys and values of every position and attends from
    its block of query rows; one position (a decode step) is attended by
    every rank whole, as the JAX package's ``_seq_shard`` leaves a
    sequence of one unsharded: no collective."""
    B, S, _ = x.shape
    hd, m = cfg.hd, ranks.axis_size("model")
    layout = tp_layout(cfg, params, m)
    window = (cfg.window if cfg.attn_type == "swa" and cross_kv is None
              else None)
    h = enter_parallel(ranks, x)
    me = axis_position(ranks, "model")

    def proj(inp, name, heads):
        y = parallel_product(inp, params[name])
        return y.reshape(inp.shape[0], inp.shape[1], heads, hd)

    split = layout == "sequence" and S > 1
    if layout == "sequence":
        if split and S % m:
            raise ValueError(f"sequence-parallel attention: {S} positions "
                             f"do not split over {m} model ranks")
        rows = (slice(me * (S // m), (me + 1) * (S // m)) if split
                else slice(None))
        hq, pq = h[:, rows], q_pos[:, rows]
        heads, kv_heads = cfg.n_heads, cfg.n_kv_heads
    else:
        hq, pq = h, q_pos
        heads = cfg.n_heads // m
        kv_heads = (cfg.n_kv_heads // m if layout == "heads"
                    and sharded_dim(params, "wk") is not None
                    else cfg.n_kv_heads)
    q = proj(hq, "wq", heads)
    if cross_kv is not None:
        k, v, kv_pos = cross_kv
    elif layout == "split_kv":
        # this rank's columns of one KV head, gathered whole (every
        # head) before k_norm and rope, which read a head's whole width
        kv = torch.stack([parallel_product(h, params["wk"]),
                          parallel_product(h, params["wv"])])
        kv = gather_heads(ranks, kv, "model", 3)
        k, v = kv.reshape(2, B, S, kv_heads, hd).unbind(0)
        kv_pos = q_pos
    else:
        k, v = proj(h, "wk", kv_heads), proj(h, "wv", kv_heads)
        kv_pos = q_pos
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        if cross_kv is None:
            k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if rope and cross_kv is None:
        q = apply_rope(q, pq, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    axes = None
    if cache is not None and cross_kv is None:
        start, axes = _block_start(cache, ranks), _time_axes(cache)
        if _cache_heads(cfg, cache, layout, kv_heads) == "gather":
            kv = gather_from(ranks, torch.stack([k, v]), "model", 3)
            cache = _cache_update(cache, kv[0], kv[1], q_pos, start)
            mine = slice(me * kv_heads, (me + 1) * kv_heads)
            k, v = cache["k"][:, :, mine], cache["v"][:, :, mine]
        else:
            cache = _cache_update(cache, k, v, q_pos, start)
            k, v = cache["k"], cache["v"]
        kv_pos = cache["pos"]
    if layout == "split_kv":
        j = kv_head_of_rank(cfg.n_heads, cfg.n_kv_heads, m, me)
        k, v = k[:, :, j:j + 1], v[:, :, j:j + 1]
    out = _sdpa(q, k, v, pq, kv_pos, causal=causal and cross_kv is None,
                window=window, scale=hd ** -0.5, ranks=ranks, axes=axes)
    out = out.reshape(B, hq.shape[1], heads * hd)
    if layout != "sequence":
        return row_parallel(ranks, out, params["wo"]), cache
    out = out @ params["wo"].to(COMPUTE_DTYPE)
    return (gather_from(ranks, out, "model", 1) if split else out), cache


def attn_apply(params, x, cfg: ModelConfig, q_pos,
               cache: Optional[Dict] = None, causal: bool = True,
               cross_kv: Optional[Tuple] = None, rope: bool = True,
               ranks=None):
    """Self- or cross-attention over x (B,S,d). ``cache=None``: keys and
    values from x itself (prefill or a full forward). A cache: write the
    new entries, then attend over the whole cache (decode, or prefill
    into a cache). ``cross_kv=(k, v, kv_pos)``: attend over keys and
    values precomputed from an encoder (only ``q_norm`` applies to q; no
    rope, no cache write). ``ranks`` holding shards
    (:func:`repro_torch.comm.model_parallel`): the model-parallel
    attention, causal or not, with rope or without (the encoder's and
    the decoder's self-attention of the enc-dec), over a full forward or
    this process's block of a cache, or cross-attention over
    ``cross_kv`` from this rank's shards
    (:func:`_attn_model_parallel`); a :class:`TimeBlock` cache, over
    process ``ranks`` whichever layout. Returns (out, cache)."""
    if model_parallel(ranks):
        return _attn_model_parallel(params, x, cfg, q_pos, ranks, causal,
                                    rope, cross_kv, cache)
    B, S, _ = x.shape
    hd = cfg.hd
    x = x.to(COMPUTE_DTYPE)
    q = (x @ params["wq"].to(COMPUTE_DTYPE)).reshape(B, S, cfg.n_heads, hd)
    if cross_kv is None:
        k = (x @ params["wk"].to(COMPUTE_DTYPE)).reshape(
            B, S, cfg.n_kv_heads, hd)
        v = (x @ params["wv"].to(COMPUTE_DTYPE)).reshape(
            B, S, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rms_norm(q, params["q_norm"], cfg.norm_eps)
            k = rms_norm(k, params["k_norm"], cfg.norm_eps)
        if rope:
            q = apply_rope(q, q_pos, cfg.rope_theta)
            k = apply_rope(k, q_pos, cfg.rope_theta)
    elif cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)

    window = cfg.window if cfg.attn_type == "swa" else None
    scale = hd ** -0.5
    if cross_kv is not None:
        ck, cv, ckv_pos = cross_kv
        out = _sdpa(q, ck, cv, q_pos, ckv_pos, causal=False, window=None,
                    scale=scale)
    elif cache is None:
        out = _sdpa(q, k, v, q_pos, q_pos, causal=causal, window=window,
                    scale=scale)
    else:
        cache = _cache_update(cache, k, v, q_pos, _block_start(cache, ranks))
        out = _sdpa(q, cache["k"], cache["v"], q_pos, cache["pos"],
                    causal=causal, window=window, scale=scale, ranks=ranks,
                    axes=_time_axes(cache))
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


# -- MLA -----------------------------------------------------------------------------


def _mla_core(q_nope, s_rope, k_nope, val, q_pos, kv_pos, scale: float,
              ranks=None, axes=None):
    """MLA's scores and output with per-head keys and values: ``q_nope``
    ``(B, S, H, nope)``, ``k_nope`` ``(B, T, H, nope)``, ``val`` ``(B, T,
    H, v)``, ``s_rope`` the rope part of the scores ``(B, 1, S, T)``,
    added to every head's; causal; ``axes``: a time block of a cache
    sharded over them, combined as :func:`_sdpa` does. Returns ``(B, S,
    H, v)`` bfloat16."""
    mask = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :]
                                        <= q_pos[:, :, None])
    s_nope = torch.einsum("bshn,bthn->bhst", q_nope.float(), k_nope.float())
    scores = (s_nope + s_rope) * scale
    del s_nope
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    probs = _softmax(scores, ranks, axes).to(COMPUTE_DTYPE)
    del scores
    out = torch.einsum("bhst,bthv->bshv", probs.float(), val.float())
    return _sum_blocks(out, ranks, axes).to(COMPUTE_DTYPE)


def _mla_cache_write(cache: Dict, ckv, k_rope, q_pos,
                     start: Optional[int] = None) -> Dict:
    """Write the latents ``ckv`` (B, S, kv_rank) and the rope key
    ``k_rope`` (B, S, 1, rope) of the new positions into an MLA cache, in
    place; ``start``: the cache is a time block from that slot
    (:func:`_write_slots`)."""
    at = _write_slots(q_pos, cache["ckv"].shape[1], start)
    _write(cache, "ckv", *at, ckv)
    _write(cache, "k_rope", *at, k_rope[..., 0, :])
    _write(cache, "pos", *at, q_pos)
    return cache


def _mla_model_parallel(params, x, cfg: ModelConfig, q_pos, ranks,
                        cache: Optional[Dict] = None):
    """MLA over the replicated ``x`` (B, S, d) on a process holding its
    shards: the latents (``cq``, ``ckv`` and the rope key, computed
    replicated) enter this rank's column blocks through one ``copy_to``,
    whose backward sums their gradient over ``model``; ``wo`` is
    row-parallel. Where ``model`` does not divide the heads
    (``"split_heads"``), a block ends inside a head: after each of
    ``wq_up``'s, ``wk_up``'s and ``wv_up``'s products one ``exchange``
    moves the pieces of each head to its owner (:func:`mla_pieces`), the
    rank attends the heads it owns (:func:`mla_owned_heads`), and before
    ``wo`` the inverse ``exchange`` returns their output columns to the
    blocks of ``wo``'s rows; each exchange's backward is its inverse.
    The rope part of the scores contracts the query's rope columns over
    every head as well (the JAX package's ``"bshr,btkr->bkst"``, the
    same for all heads): each rank sums its heads' (the heads it owns)
    and one ``psum`` forward (``reduce_from``) and one backward
    (``copy_to``) join them, ``(B, S, rope)`` float32 each. The output
    is replicated.

    ``cache``: this process's block (its data rows, every slot or a
    :class:`TimeBlock`'s: the latent cache's spec has no ``model``
    entry). Every rank writes the new latents and rope keys whole, then
    its heads take ``wk_up`` and ``wv_up`` of the block's latents (the
    ``absorb=False`` path) and the rope scores read the cached rope
    keys; a time block's scores are combined over its axes."""
    B, S, _ = x.shape
    m = ranks.axis_size("model")
    layout = tp_layout(cfg, params, m)
    me = axis_position(ranks, "model")
    nope, rope_d, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    qr, r = cfg.q_lora_rank, cfg.kv_lora_rank
    H = len(mla_owned_heads(cfg.n_heads, m, me))

    def own(y, width, back=False):
        """``y``'s last dimension from this rank's column block to the
        columns of the heads it owns (``back``: the inverse)."""
        if layout == "heads":
            return y
        send, recv = mla_pieces(cfg.n_heads, width, m)
        send, recv = send[me], recv[me]
        if back:
            send, recv = recv, send
        return exchange(ranks, y, send, recv, "model", -1)

    x = x.to(COMPUTE_DTYPE)
    cq = rms_norm(x @ params["wq_down"].to(COMPUTE_DTYPE), params["q_norm"],
                  cfg.norm_eps)
    ckv_full = x @ params["wkv_down"].to(COMPUTE_DTYPE)
    ckv = rms_norm(ckv_full[..., :r], params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., r:].reshape(B, S, 1, rope_d), q_pos,
                        cfg.rope_theta)
    if cache is None:
        lat = enter_parallel(ranks, torch.cat(
            [cq, ckv, k_rope.reshape(B, S, rope_d)], dim=-1))
        cqf, ckvf, krf = lat.split([qr, r, rope_d], dim=-1)
        kv_pos = q_pos
    else:
        cache = _mla_cache_write(cache, ckv, k_rope, q_pos,
                                 _block_start(cache, ranks))
        cqf = enter_parallel(ranks, cq)
        ckvf = enter_parallel(ranks, cache["ckv"])
        krf = cache["k_rope"].to(COMPUTE_DTYPE).float()
        kv_pos = cache["pos"]
    T = ckvf.shape[1]
    q = own(parallel_product(cqf, params["wq_up"]), nope + rope_d)
    q = q.reshape(B, S, H, nope + rope_d)
    q_rope = apply_rope(q[..., nope:], q_pos, cfg.rope_theta)
    q_rope = copy_to(ranks, reduce_from(ranks, q_rope.float().sum(dim=2),
                                        "model"), "model")
    s_rope = torch.einsum("bsr,btr->bst", q_rope,
                          krf.to(COMPUTE_DTYPE).float())[:, None]
    k_nope = own(parallel_product(ckvf, params["wk_up"]), nope)
    val = own(parallel_product(ckvf, params["wv_up"]), vh)
    out = _mla_core(q[..., :nope], s_rope, k_nope.reshape(B, T, H, nope),
                    val.reshape(B, T, H, vh), q_pos, kv_pos,
                    (nope + rope_d) ** -0.5, ranks, _time_axes(cache))
    out = own(out.reshape(B, S, H * vh), vh, back=True)
    return row_parallel(ranks, out, params["wo"]), cache


def mla_apply(params, x, cfg: ModelConfig, q_pos,
              cache: Optional[Dict] = None, absorb: bool = False,
              ranks=None):
    """DeepSeek-V2-style multi-head latent attention (MiniCPM3).

    The KV cache is the compressed latent (``ckv``, ``k_rope``), written
    in place. ``absorb=False`` materializes per-head K/V from the latent
    (the model path); ``absorb=True`` folds ``wk_up``/``wv_up`` into the
    query and the output, every product from float32 operands, as the
    JAX package computes it. ``ranks`` holding shards
    (:func:`repro_torch.comm.model_parallel`): the heads-sharded MLA of
    the module docstring, over a full forward or this process's block of
    a cache (:func:`_mla_model_parallel`); absorption over ranks is not
    ported. Returns (out, cache)."""
    if model_parallel(ranks):
        if absorb:
            raise ValueError("model-parallel MLA with absorb=True (wk_up "
                             "and wv_up folded into the query and the "
                             "output over sharded heads): not ported")
        return _mla_model_parallel(params, x, cfg, q_pos, ranks, cache)
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope_d, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    x = x.to(COMPUTE_DTYPE)

    cq = rms_norm(x @ params["wq_down"].to(COMPUTE_DTYPE), params["q_norm"],
                  cfg.norm_eps)
    q = (cq @ params["wq_up"].to(COMPUTE_DTYPE)).reshape(B, S, H,
                                                         nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, q_pos, cfg.rope_theta)

    ckv_full = x @ params["wkv_down"].to(COMPUTE_DTYPE)
    ckv = rms_norm(ckv_full[..., :r], params["kv_norm"], cfg.norm_eps)
    k_rope = ckv_full[..., r:].reshape(B, S, 1, rope_d)
    k_rope = apply_rope(k_rope, q_pos, cfg.rope_theta)

    axes = _time_axes(cache)
    if cache is not None:
        cache = _mla_cache_write(cache, ckv, k_rope, q_pos,
                                 _block_start(cache, ranks))
        ckv_t = cache["ckv"].to(COMPUTE_DTYPE)
        k_rope_t = cache["k_rope"][:, :, None].to(COMPUTE_DTYPE)
        kv_pos = cache["pos"]
    else:
        ckv_t, k_rope_t, kv_pos = ckv, k_rope, q_pos

    scale = (nope + rope_d) ** -0.5
    # rope-part scores (one shared kv head, contracted over every head as
    # well, as the JAX package's einsum does): (B, 1, S, T)
    s_rope = torch.einsum("bshr,btkr->bkst", q_rope.float(), k_rope_t.float())
    if absorb:
        mask = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :]
                                            <= q_pos[:, :, None])
        wk = params["wk_up"].float().reshape(r, H, nope)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(), wk)
        ckv_f = ckv_t.float()
        s_nope = torch.einsum("bshr,btr->bhst", q_lat, ckv_f)
        scores = (s_nope + s_rope) * scale          # (B,H,S,T)
        del s_nope
        scores = scores.masked_fill(~mask[:, None], NEG_INF)
        probs = _softmax(scores, ranks, axes)
        del scores
        o_lat = _sum_blocks(torch.einsum("bhst,btr->bshr", probs, ckv_f),
                            ranks, axes)
        wv = params["wv_up"].float().reshape(r, H, vh)
        out = torch.einsum("bshr,rhv->bshv", o_lat, wv).to(COMPUTE_DTYPE)
    else:
        T = ckv_t.shape[1]
        k_nope = (ckv_t @ params["wk_up"].to(COMPUTE_DTYPE)).reshape(
            B, T, H, nope)
        val = (ckv_t @ params["wv_up"].to(COMPUTE_DTYPE)).reshape(B, T, H, vh)
        out = _mla_core(q_nope, s_rope, k_nope, val, q_pos, kv_pos, scale,
                        ranks, axes)

    out = out.reshape(B, S, H * vh) @ params["wo"].to(COMPUTE_DTYPE)
    return out, cache


def init_cache_mla(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=COMPUTE_DTYPE, device=None) -> Dict:
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }
