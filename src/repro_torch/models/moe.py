"""Mixture-of-Experts with Sphere bucket-shuffle dispatch.

Port of ``repro/models/moe.py``. The paper's bucket shuffle (§3.2) *is*
expert dispatch: record = token, bucket = expert, capacity factor = the
scheduler's segment-size clamp (§3.5.1), dropped-on-overflow = the same
bounded-skew contract. The ``sphere`` implementation routes tokens
through :class:`repro_torch.core.shuffle.ShufflePlan` over the expert
ranks of a :class:`repro_torch.comm.Ranks` grid (the JAX package's
``model`` mesh axis, or ``(dc, node)`` for wide-area expert parallelism);
both its partition/packs, the send pack and the per-expert regroup, are
:func:`repro_torch.kernels.ops.partition_pack`, so kernel K1 on the card.
The ``dense`` implementation is the one-hot (Switch-style) capacity
dispatch, used for small token counts (decode) and as the baseline.

Experts are zero-padded to a multiple of 16 (qwen2-moe: 60 -> 64); the
router never selects padding experts. The sphere dispatch sizes its
buckets for the expert axis it runs on; where the two padded counts
differ (most axis sizes for 60 experts) it raises, at the shapes where
the JAX package fails.

On :class:`repro_torch.comm.ProcessRanks` each process runs the JAX
package's ``shard_map`` body for its own block of tokens, with the
expert weights it holds: rows ``me * e_loc : (me + 1) * e_loc`` of
``w_gate``, ``w_up`` and ``w_down``, the shard that their spec
``("model", None, None)`` gives it (:func:`local_params`). Inside a
model-parallel block (:func:`moe_apply_parallel`) the process takes its
sequence block of its data row's replicated activation, dispatches it,
and ``gather_from`` joins the blocks again; the shared experts are
column- then row-parallel over ``model``. Where the positions do not
split over ``model`` (every decode step), the JAX package's gate takes
the dense dispatch, and so does the process: over its block of the
routed experts, the capacity counted over the whole batch
(:func:`moe_apply_dense_parallel`).

``moe_aux`` and ``moe_dropped`` are data row 0's values, as the JAX
package's ``out_specs=P()`` hands them out; the gradient of ``moe_aux``
is every data row's own, each weighted ``1 / rows``, as the transpose
of that ``shard_map`` gives it (its cotangent divided over the devices,
the router's gradient summed over them). Only the router reads it: the
token rows and their routing weights travel framed as bytes, so the
routed experts get no gradient and the router gets none through them.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch

from repro_torch.comm import (Ranks, Spec, axis_position, gather_from,
                              reduce_from)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.shuffle import ShufflePlan
from repro_torch.kernels.ops import partition_pack
from repro_torch.models.layers import (COMPUTE_DTYPE, Params, dense_init,
                                       enter_parallel, parallel_product,
                                       silu)


def padded_experts(cfg: ModelConfig, tp: int = 16) -> int:
    e = cfg.num_experts
    return ((e + tp - 1) // tp) * tp


def plan_experts(cfg: ModelConfig, e_weights: int, ep: int) -> int:
    """The experts the dispatch plans for over ``ep`` expert ranks, which
    must be the ``e_weights`` the weights hold; where the two paddings
    differ the JAX package fails inside ``shard_map``, and this raises."""
    e_plan = padded_experts(cfg, ep)
    if e_weights != e_plan:
        raise ValueError(f"the expert weights hold {e_weights} experts, but "
                         f"{ep} expert ranks pad {cfg.num_experts} experts "
                         f"to {e_plan}")
    return e_plan


class MoE(Params):
    """``router`` ``(d, E)`` float32; routed experts ``w_gate``/``w_up``
    ``(E_pad, d, f)`` and ``w_down`` ``(E_pad, f, d)``; with shared
    experts ``ws_gate``/``ws_up`` ``(d, n_s * f_s)``, ``ws_down`` and
    ``shared_gate`` ``(d, 1)`` float32."""

    def __init__(self, cfg: ModelConfig, tp: int = 16, device=None):
        super().__init__()
        self.cfg = cfg
        e_pad = padded_experts(cfg, tp)
        d, f = cfg.d_model, cfg.expert_d_ff
        self.add("router", (d, cfg.num_experts), torch.float32, device,
                 spec=(None, None))
        self.add("w_gate", (e_pad, d, f), COMPUTE_DTYPE, device,
                 spec=("model", None, None))
        self.add("w_up", (e_pad, d, f), COMPUTE_DTYPE, device,
                 spec=("model", None, None))
        self.add("w_down", (e_pad, f, d), COMPUTE_DTYPE, device,
                 spec=("model", None, None))
        if cfg.n_shared_experts:
            fs = cfg.shared_d_ff * cfg.n_shared_experts
            self.add("ws_gate", (d, fs), COMPUTE_DTYPE, device,
                     spec=(None, "model"))
            self.add("ws_up", (d, fs), COMPUTE_DTYPE, device,
                     spec=(None, "model"))
            self.add("ws_down", (fs, d), COMPUTE_DTYPE, device,
                     spec=("model", None))
            self.add("shared_gate", (d, 1), torch.float32, device,
                     spec=(None, None))

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """``moe_init``'s draws: padded experts of ``w_gate``/``w_up``
        zeroed (``w_down``'s are not, as there)."""
        cfg = self.cfg
        d, f = cfg.d_model, cfg.expert_d_ff
        dense_init(self.router, generator, scale=0.02)
        dense_init(self.w_gate, generator, d ** -0.5, cfg.num_experts)
        dense_init(self.w_up, generator, d ** -0.5, cfg.num_experts)
        dense_init(self.w_down, generator, f ** -0.5)
        if cfg.n_shared_experts:
            dense_init(self.ws_gate, generator)
            dense_init(self.ws_up, generator)
            dense_init(self.ws_down, generator)
            dense_init(self.shared_gate, generator, scale=0.02)

    def forward(self, x, ranks: Optional[Ranks] = None,
                dp_axes: Sequence[str] = ("data",), tp_axis: str = "model",
                ep_axes: Optional[Sequence[str]] = None, chunks: int = 1):
        return moe_apply(self, x, self.cfg, ranks, dp_axes, tp_axis,
                         ep_axes, chunks)


def _route(params, x_flat: torch.Tensor, cfg: ModelConfig):
    """Router over ``x_flat`` ``(..., n, d)``: top-k expert ids and
    renormalised probabilities (float32), and the load-balance aux loss
    (Switch: E * sum_e f_e * P_e) over the ``n`` tokens, ``(...)``."""
    logits = x_flat.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    me = torch.mean(probs, dim=-2)
    # one-hot by comparison: F.one_hot checks its ids on the host, which
    # waits for the card
    experts = torch.arange(cfg.num_experts, device=top_i.device)
    hits = (top_i[..., None] == experts).float().sum(dim=-2)
    ce = torch.mean(hits, dim=-2) / cfg.top_k
    aux = cfg.num_experts * torch.sum(me * ce, dim=-1)
    return top_i.to(torch.int32), top_p.float(), aux


def _expert_ffn(w_gate, w_up, w_down, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, d) tokens grouped per expert; weights (E, d, f) and
    (E, f, d). One batched product a weight."""
    xe = xe.to(COMPUTE_DTYPE)
    h = silu(torch.bmm(xe, w_gate.to(COMPUTE_DTYPE)))
    h = h * torch.bmm(xe, w_up.to(COMPUTE_DTYPE))
    return torch.bmm(h, w_down.to(COMPUTE_DTYPE))


def _shared_ffn(params, x: torch.Tensor, ranks=None,
                xf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The shared experts over ``x``. Model-parallel (``ranks`` given,
    ``xf`` the replicated ``x`` from :func:`repro_torch.models.layers.
    enter_parallel`): ``ws_gate``/``ws_up`` column- and ``ws_down``
    row-parallel, the sum over ranks rounded once; ``shared_gate`` reads
    the replicated ``x`` itself, so its gradient and the one it gives
    ``x`` are whole on every rank."""
    x = x.to(COMPUTE_DTYPE)
    if ranks is None:
        h = silu(x @ params["ws_gate"].to(COMPUTE_DTYPE))
        h = h * (x @ params["ws_up"].to(COMPUTE_DTYPE))
        out = h @ params["ws_down"].to(COMPUTE_DTYPE)
    else:
        out = reduce_from(ranks, _shared_part(params, xf), "model").to(
            COMPUTE_DTYPE)
    return out * _shared_gate(params, x)


def _shared_part(params, xf: torch.Tensor) -> torch.Tensor:
    """This rank's float32 part of the model-parallel shared experts'
    output (:func:`repro_torch.models.layers.row_parallel`'s before its
    sum)."""
    h = silu(parallel_product(xf, params["ws_gate"]))
    h = h * parallel_product(xf, params["ws_up"])
    return h.to(COMPUTE_DTYPE).float() @ params["ws_down"].to(
        COMPUTE_DTYPE).float()


def _shared_gate(params, x: torch.Tensor) -> torch.Tensor:
    """The shared experts' gate, ``sigmoid(x @ shared_gate)`` in
    bfloat16."""
    g = (x.to(COMPUTE_DTYPE) @ params["shared_gate"].to(
        COMPUTE_DTYPE)).float()
    return (1.0 / (1.0 + torch.exp(-g))).to(COMPUTE_DTYPE)  # jax.nn.sigmoid


class _RowZeroValue(torch.autograd.Function):
    """Forward ``value`` (data row 0's ``moe_aux``); backward the
    gradient of ``rows.mean()``: each data row's own aux takes ``1 /
    rows`` of it (a process holds its row's: all of it)."""

    @staticmethod
    def forward(ctx, rows, value):
        ctx.shape = rows.shape
        return value.detach().clone()

    @staticmethod
    def backward(ctx, g):
        return g.expand(ctx.shape) / math.prod(ctx.shape), None


# -- sphere (bucket shuffle) dispatch ----------------------------------------------


def _moe_sphere_local(params: Mapping[str, torch.Tensor], x_local,
                      cfg: ModelConfig, plan: ShufflePlan, ranks: Ranks,
                      dp: int, dp_axes: Sequence[str] = ()):
    """The JAX package's ``shard_map`` body on stacked ranks. ``x_local``
    ``(R, b, s_loc, d)``: every rank's tokens, distinct per rank. Ranks
    are ordered ``(dp, ep)`` row-major: ``dp`` groups (the data rows,
    along ``dp_axes``) running the plan side by side over ``ep`` expert
    ranks each, which hold the same experts from one group to the next.
    On process ranks ``R`` is 1 and ``params`` hold the process's own
    experts. ``moe_aux`` and ``moe_dropped`` as the module docstring
    says."""
    R, b, s_loc, d = x_local.shape
    local = R != ranks.world          # one process's row of the grid
    n = b * s_loc
    x_flat = x_local.reshape(R, n, d)
    top_i, top_p, aux = _route(params, x_flat, cfg)

    k = cfg.top_k
    ep = plan.num_devices
    # records: token replicated k times, carrying its routing prob, in
    # bfloat16 on the wire (the bits, not a value cast)
    rec = torch.cat([torch.repeat_interleave(x_flat.to(COMPUTE_DTYPE), k,
                                             dim=1),
                     top_p.reshape(R, n * k, 1).to(COMPUTE_DTYPE)], dim=2)
    buckets = top_i.reshape(R, n * k)
    num_buckets = plan.num_buckets
    res = plan.shuffle(ranks, rec, buckets)

    # local regroup (stage C of the shuffle, on the device): received rows
    # -> (E_loc, C2, d) per local expert, by the same partition/pack (K1)
    e_loc = num_buckets // ep
    me = plan.device_index(ranks)
    flat = res.data.reshape(R, -1, d + 1)
    fvalid = res.valid.reshape(R, -1)
    fbucket = res.bucket.reshape(R, -1) - me[:, None] * e_loc
    n_recv = flat.shape[1]
    c2 = int(n_recv / e_loc * cfg.capacity_factor) + 1
    dest = torch.where(fvalid, fbucket, e_loc)          # invalid -> overflow
    (grouped,), in_rng, origin, _ = partition_pack([flat], dest, e_loc, c2)
    xe, pe = grouped[..., :d], grouped[..., d]

    # one batched product a weight: the data rows of one expert column
    # fold into the capacity axis, (dp, ep, e_loc, C2, d) -> (ep * e_loc,
    # dp * C2, d), so the weights are read as stored, never copied per
    # rank; a process holds one row of one column, (1, 1)
    rows, cols = (1, 1) if local else (dp, ep)
    xe = xe.reshape(rows, cols * e_loc, c2, d).transpose(0, 1).reshape(
        cols * e_loc, rows * c2, d)
    ye = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xe)
    ye = ye.reshape(cols * e_loc, rows, c2, d).transpose(0, 1).reshape(
        R, e_loc, c2, d)
    ye = ye * pe[..., None].to(COMPUTE_DTYPE)           # weight by router prob
    ye = ye * in_rng[..., None].to(COMPUTE_DTYPE)

    # inverse regroup: back to the received-row layout; origin is the
    # source row of each (expert, slot); empty slots go to one overflow
    # row per rank that is cut off
    rows = torch.where(in_rng, origin, n_recv).to(torch.int64)
    rows = rows + torch.arange(R, device=rows.device)[:, None, None] * (
        n_recv + 1)
    back = torch.zeros((R * (n_recv + 1), d), dtype=COMPUTE_DTYPE,
                       device=ye.device)
    back[rows.reshape(-1)] = ye.reshape(-1, d)
    processed = back.reshape(R, n_recv + 1, d)[:, :n_recv].reshape(
        res.data.shape[:3] + (d,))

    # combine back to the n*k record rows, then sum each token's k expert
    # contributions
    combined, _ = plan.combine(ranks, processed, res, n * k)
    out = combined.reshape(R, n, k, d).sum(dim=2).reshape(R, b, s_loc, d)
    # pmean over the plan's axes (reduce_from: each expert rank's gradient
    # is its own tokens' part); shard_map's out_specs=P() then hands out
    # data row 0's value, as it does the drop count
    dropped = res.dropped if res.dropped.dim() == 0 else res.dropped[0]
    if not local:
        rows = aux.reshape(dp, ep).mean(dim=1)
        return out, _RowZeroValue.apply(rows, rows[0]), dropped
    aux = reduce_from(ranks, aux[0], plan.axes) / ep
    if dp > 1:
        first = float(axis_position(ranks, dp_axes) == 0)
        both = torch.stack([aux.detach(), dropped.float()]) * first
        both = ranks.psum(both.unsqueeze(0), tuple(dp_axes)).reshape(2)
        aux = _RowZeroValue.apply(aux, both[0])
        dropped = both[1].to(dropped.dtype)
    return out, aux, dropped


def _grid_layout(ranks: Ranks, lead: Sequence[str], ep_axes: Sequence[str]):
    """Check that the grid is ``lead + ep_axes``, in that order (the
    layout whose row-major ranks the stacked views below assume)."""
    want = tuple(lead) + tuple(ep_axes)
    if tuple(ranks.axes) != want:
        raise ValueError(f"the sphere MoE runs on a grid with axes {want} "
                         f"in that order; got {ranks!r}")


def moe_apply_sphere(params, x: torch.Tensor, cfg: ModelConfig,
                     ranks: Ranks, dp_axes: Sequence[str],
                     tp_axis: str = "model",
                     ep_axes: Optional[Sequence[str]] = None,
                     chunks: int = 1):
    """x: (B, S, d) with S divisible by the expert axis size.

    Flat: the batch shards over ``dp_axes``, the sequence and the experts
    over ``tp_axis``. ``ep_axes=(dc_axis, node_axis)`` spreads the experts
    over *both* axes — wide-area expert parallelism, tokens crossing the
    DC boundary through the hierarchical two-level shuffle (batch over the
    dc axis, sequence over the node axis). ``chunks=W`` pipelines the
    dispatch shuffle in W rounds.

    On :class:`repro_torch.comm.ProcessRanks`, ``x`` is the global input
    all the same (as ``shard_map`` takes it), ``params`` hold the
    process's expert shard (:func:`local_params`), and the output is the
    process's block of the global output, ``(B / rows, S / cols, d)``,
    the block the input spec gives it. ``moe_aux`` and ``moe_dropped`` are
    data row 0's (one ``psum`` over the data axes more where there are
    several rows); the mean of ``moe_aux`` over the expert ranks is one
    ``psum`` more than stacked ranks count."""
    b, s, d = x.shape
    k = cfg.top_k
    if ep_axes is not None:
        ep_axes = tuple(ep_axes)
        _grid_layout(ranks, (), ep_axes)
        ep = ranks.axis_size(ep_axes)
        rows, cols = (ranks.axis_size(a) for a in ep_axes)
        dp = 1
    else:
        ep_axes = (tp_axis,)
        _grid_layout(ranks, dp_axes, ep_axes)
        ep = ranks.axis_size(tp_axis)
        rows, cols = ranks.axis_size(tuple(dp_axes)), ep
        dp = rows
    if b % rows or s % cols:
        raise ValueError(f"x of shape {tuple(x.shape)} does not shard over "
                         f"the {rows} x {cols} grid")
    n_local = (b // rows) * (s // cols)
    local = ranks.rows != ranks.world
    e_plan = plan_experts(cfg, params["w_gate"].shape[0]
                          * (ep if local else 1), ep)
    plan = ShufflePlan.for_ranks(ranks, e_plan, n_local * k,
                                 cfg.capacity_factor, ep_axes, chunks=chunks)
    if local:
        x = token_block(x, rows, cols, ranks.rank)
        out, aux, dropped = _moe_sphere_local(params, x[None], cfg, plan,
                                              ranks, dp, dp_axes)
        out = out[0]
    else:
        # x (B, S, d) -> per rank (R, b_loc, s_loc, d), ranks row-major
        # over (batch rows, sequence columns)
        x_local = x.reshape(rows, b // rows, cols, s // cols, d).transpose(
            1, 2).reshape(rows * cols, b // rows, s // cols, d)
        out, aux, dropped = _moe_sphere_local(params, x_local, cfg, plan,
                                              ranks, dp)
        out = out.reshape(rows, cols, b // rows, s // cols, d).transpose(
            1, 2).reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(params, x)
    return out, {"moe_aux": aux, "moe_dropped": dropped}


def moe_apply_parallel(params, h: torch.Tensor, cfg: ModelConfig,
                       ranks: Ranks, dp_axes: Sequence[str] = ("data",)):
    """The MoE of a model-parallel block over process ranks
    (:func:`repro_torch.comm.model_parallel`): ``h`` ``(b, S, d)`` is this
    process's data row of the activation, replicated over ``model``,
    and ``params`` hold the process's shards (the routed experts' and the
    shared experts' blocks by their specs, the router and ``shared_gate``
    whole). The output is replicated too. The JAX package's gate: the
    sphere dispatch where the ``S`` positions split over ``model``
    (training, a prefill), else the expert-sharded dense dispatch
    (:func:`moe_apply_dense_parallel`: every decode step; it serves only,
    without gradients).

    Sphere: ``h`` enters once through ``enter_parallel`` (whose backward
    sums its gradient over ``model``). The process dispatches its block
    of ``S / model`` positions, the block ``P(dp, "model", None)`` gives
    it in the JAX package's ``shard_map``, with K1 in the send pack and
    the regroup, and ``gather_from`` joins the blocks' outputs; the
    shared experts run on the whole ``h``. The router reads the
    process's own tokens only: its gradient is a part of the whole,
    summed over ``model`` by the trainer."""
    b, s, d = h.shape
    m = ranks.axis_size("model")
    if cfg.moe_impl != "sphere" or s % m:
        return moe_apply_dense_parallel(params, h, cfg, ranks, dp_axes)
    _grid_layout(ranks, dp_axes, ("model",))
    s_loc = s // m
    plan = ShufflePlan.for_ranks(
        ranks, plan_experts(cfg, params["w_gate"].shape[0] * m, m),
        b * s_loc * cfg.top_k, cfg.capacity_factor, ("model",))
    hf = enter_parallel(ranks, h)
    shared = (_shared_ffn(params, h, ranks, hf) if cfg.n_shared_experts
              else None)
    c = axis_position(ranks, "model")
    block = hf[:, c * s_loc:(c + 1) * s_loc]
    out, aux, dropped = _moe_sphere_local(
        params, block[None], cfg, plan, ranks,
        ranks.axis_size(tuple(dp_axes)), dp_axes)
    out = gather_from(ranks, out[0], "model", 1)
    if shared is not None:
        out = out + shared
    return out, {"moe_aux": aux, "moe_dropped": dropped}


def token_block(x: torch.Tensor, rows: int, cols: int,
                rank: int) -> torch.Tensor:
    """The tokens of the global ``(B, S, ...)`` ``x`` that flat ``rank``
    of a ``rows x cols`` layout holds, ranks row-major: row ``rank //
    cols`` of ``rows`` batch blocks, column ``rank % cols`` of ``cols``
    sequence blocks (the block of ``P(batch_axes, sequence_axes)``)."""
    r, c = divmod(rank, cols)
    b, s = x.shape[:2]
    return x[r * (b // rows):(r + 1) * (b // rows),
             c * (s // cols):(c + 1) * (s // cols)]


def local_params(params, specs: Mapping[str, Spec], ranks) -> dict:
    """The parameters a process passes to :func:`moe_apply_sphere`: the
    routed experts ``w_gate``, ``w_up`` and ``w_down`` cut to the block
    their spec in ``specs`` gives this process
    (:meth:`repro_torch.comm.ProcessRanks.local_shard`, a view), every
    other parameter whole, as the JAX package's ``shard_map`` takes the
    router (``in_specs`` ``P(None, None)``) and runs the shared experts
    outside it. ``specs``: :meth:`MoE.specs`, or ``(("dc", "node"), None,
    None)`` for the routed experts of the wide-area dispatch."""
    return {name: (ranks.local_shard(params[name], specs[name])
                   if name in ("w_gate", "w_up", "w_down") else params[name])
            for name in specs}


# -- dense (one-hot) dispatch --------------------------------------------------------


def moe_apply_dense(params, x: torch.Tensor, cfg: ModelConfig):
    """Switch-style capacity dispatch, no ranks. The JAX package builds it
    from one-hot einsums; here the same slots are indexed directly: each
    (token, choice) takes position ``pos`` in its expert, counted in
    token-major order, and is kept while ``pos < cap``. The slots hold
    float32, as the JAX package's einsums do, so that the backward sums a
    token's k gradients in float32 before its one rounding to bfloat16."""
    b, s, d = x.shape
    n = b * s
    x_flat = x.reshape(n, d)
    top_i, top_p, aux = _route(params, x_flat, cfg)
    e_pad = params["w_gate"].shape[0]
    k = cfg.top_k
    cap = max(int(n * k / cfg.num_experts * cfg.capacity_factor), 1)

    ids = top_i.reshape(n * k).long()
    oh = (ids[:, None] == torch.arange(e_pad, device=ids.device)).to(
        torch.int32)                                         # (n*k, E)
    pos = (torch.cumsum(oh, dim=0) - 1).gather(1, ids[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, ids * cap + pos, e_pad * cap)   # overflow slot
    xe = torch.zeros((e_pad * cap + 1, d), dtype=torch.float32,
                     device=x.device)
    xe[slot] = torch.repeat_interleave(x_flat.float(), k, dim=0)
    ye = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                     xe[:-1].reshape(e_pad, cap, d))
    ye = torch.cat([ye.reshape(e_pad * cap, d),
                    ye.new_zeros((1, d))]).float()
    w = top_p.reshape(n * k, 1) * keep[:, None].float()
    out = (ye[slot] * w).reshape(n, k, d).sum(dim=1)
    dropped = torch.sum(1.0 - keep.float())
    out = out.reshape(b, s, d).to(COMPUTE_DTYPE)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(params, x)
    return out, {"moe_aux": aux, "moe_dropped": dropped}


def moe_apply_dense_parallel(params, h: torch.Tensor, cfg: ModelConfig,
                             ranks: Ranks,
                             dp_axes: Sequence[str] = ("data",)):
    """:func:`moe_apply_dense` of the whole batch over process ranks,
    expert-sharded: ``h`` ``(b, S, d)`` is this process's data rows,
    replicated over ``model``; ``params`` hold the process's block of
    ``E_pad / model`` routed experts (``("model", None, None)``) and
    the shared experts' column and row blocks. Serving only (no
    gradients).

    Every model rank routes its replicated tokens with the replicated
    router, so all agree. The capacity is the whole batch's, as the JAX
    package's dense dispatch over the global batch counts it: ``cap``
    from the global token count, and each (token, choice) takes the slot
    its expert's count reaches in token-major order over the whole
    batch, so a data rank starts each expert's count at the lower data
    ranks' total. One ``all_gather`` over the data axes of this rank's
    per-expert counts and router probability sums (float32, exact
    counts) gives those totals, the global ``moe_aux`` and the global
    drop count (each expert keeps ``min(count, cap)``). The rank runs its
    experts' slots; one ``reduce_from`` over ``model`` sums the ranks'
    float32 outputs and, beside them in the same call, the shared
    experts' row-parallel parts, each sum rounded to bfloat16 once as the
    one process rounds it."""
    if torch.is_grad_enabled():
        raise ValueError(f"{cfg.arch_id}: the model-parallel dense dispatch "
                         f"(positions that do not split over model, or "
                         f"moe_impl={cfg.moe_impl!r}) serves only, without "
                         f"gradients; training dispatches through the "
                         f"sphere shuffle")
    b, s, d = h.shape
    n, k = b * s, cfg.top_k
    m = ranks.axis_size("model")
    e_loc = params["w_gate"].shape[0]
    e_pad = e_loc * m
    x_flat = h.reshape(n, d)
    top_i, top_p, _ = _route(params, x_flat, cfg)
    probs = torch.softmax(x_flat.float() @ params["router"].float(), dim=-1)
    ids = top_i.reshape(n * k).long()
    oh = (ids[:, None] == torch.arange(e_pad, device=ids.device)).to(
        torch.int32)                                         # (n*k, E)
    mine = torch.cat([oh.sum(dim=0).float(),
                      probs.sum(dim=0)])                     # (E_pad + E,)
    dp = ranks.axis_size(tuple(dp_axes))
    if dp > 1:
        every = ranks.all_gather(mine[None, None], tuple(dp_axes))
        every = every.reshape(dp, -1)
        row = axis_position(ranks, dp_axes)
        prefix = every[:row, :e_pad].sum(dim=0).to(torch.int32)
        total = every.sum(dim=0)
    else:
        prefix = torch.zeros(e_pad, dtype=torch.int32, device=h.device)
        total = mine
    n_all = n * dp
    counts, psum = total[:e_pad], total[e_pad:]
    cap = max(int(n_all * k / cfg.num_experts * cfg.capacity_factor), 1)
    pos = (torch.cumsum(oh, dim=0) - 1 + prefix).gather(
        1, ids[:, None])[:, 0]
    first = axis_position(ranks, "model") * e_loc
    keep = pos < cap
    here = keep & (ids >= first) & (ids < first + e_loc)
    slot = torch.where(here, (ids - first) * cap + pos, e_loc * cap)
    xe = torch.zeros((e_loc * cap + 1, d), dtype=torch.float32,
                     device=h.device)
    xe[slot] = torch.repeat_interleave(x_flat.float(), k, dim=0)
    ye = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                     xe[:-1].reshape(e_loc, cap, d))
    ye = torch.cat([ye.reshape(e_loc * cap, d),
                    ye.new_zeros((1, d))]).float()
    w = top_p.reshape(n * k, 1) * here[:, None].float()
    parts = [(ye[slot] * w).reshape(n, k, d).sum(dim=1)]
    if cfg.n_shared_experts:
        parts.append(_shared_part(params, enter_parallel(ranks, x_flat)))
    sums = reduce_from(ranks, torch.stack(parts), "model").to(COMPUTE_DTYPE)
    out = sums[0].reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + (sums[1] * _shared_gate(params, x_flat)).reshape(b, s, d)
    hits = counts[:cfg.num_experts] / n_all / k
    aux = cfg.num_experts * torch.sum(psum / n_all * hits)
    dropped = torch.clamp(counts - cap, min=0).sum()
    return out, {"moe_aux": aux, "moe_dropped": dropped}


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig,
              ranks: Optional[Ranks] = None,
              dp_axes: Sequence[str] = ("data",), tp_axis: str = "model",
              ep_axes: Optional[Sequence[str]] = None, chunks: int = 1):
    """The JAX package's gate: the sphere bucket shuffle when the sequence
    shards over the expert axis, the dense dispatch otherwise. Like the
    JAX gate, ``ep_axes`` and the grid are preferences: when the grid
    lacks the axes or the batch or sequence do not divide them (every
    decode step), this falls back to the flat or dense path silently.
    Call :func:`moe_apply_sphere` directly for a hard error."""
    if (ep_axes is not None and ranks is not None and len(ep_axes) == 2
            and all(a in ranks.axes for a in ep_axes)):
        dcs, nodes = (ranks.axis_size(a) for a in ep_axes)
        if (cfg.moe_impl == "sphere" and x.shape[0] % dcs == 0
                and x.shape[1] % nodes == 0 and dcs * nodes > 1):
            return moe_apply_sphere(params, x, cfg, ranks, dp_axes, tp_axis,
                                    ep_axes=ep_axes, chunks=chunks)
    use_sphere = (
        cfg.moe_impl == "sphere" and ranks is not None
        and tp_axis in ranks.axes
        and x.shape[1] % ranks.axis_size(tp_axis) == 0
        and ranks.axis_size(tp_axis) > 1
    )
    if use_sphere:
        return moe_apply_sphere(params, x, cfg, ranks, dp_axes, tp_axis,
                                chunks=chunks)
    return moe_apply_dense(params, x, cfg)
