"""State-space and recurrent blocks: Mamba2 (SSD) for zamba2, mLSTM and
sLSTM for xlstm.

Port of ``repro/models/ssm.py``. Prefill paths are chunk-parallel
(quadratic only within a chunk, linear across chunks); decode paths are
O(1)-state recurrent steps. The JAX package's ``lax.scan`` over chunks
(SSD, mLSTM) or time steps (sLSTM) is a Python loop here, each step on
explicit tensors; the ops and their roundings follow the JAX functions
one by one (bfloat16 where they cast to it, float32 elsewhere).

Cache contracts, as there (the port writes a given cache in place and
returns it):

- mamba2: ``{"ssm": (B,H,P,N) fp32, "conv_x": (B,K-1,d_in),
  "conv_bc": (B,K-1,2N)}``
- mLSTM: ``{"C": (B,H,P,P) fp32, "n": (B,H,P), "m": (B,H), "conv":
  (B,K-1,d_in)}``
- sLSTM: ``{"c", "n", "h", "m": (B,H,P)}``

Model-parallel (training over process ranks, where
:func:`repro_torch.comm.model_parallel` holds) each block keeps the
blocks its specs give the process, and a rank runs its heads:

- Mamba2 and mLSTM: the ``[z | x]`` projection is column-parallel over
  the concatenated columns, so a rank's block is not its heads' z and x
  (at ``model`` = 2 rank 0 holds all of z): one :func:`repro_torch.comm.
  exchange` gives each rank its heads' channels of both, which the conv,
  the ``norm`` and the output projection's blocks match. The norm sums
  its squares over ``model`` (:func:`repro_torch.models.layers.
  rms_norm_parallel`); the output projection is row-parallel.
- Mamba2's B, C and dt (``in_bcdt``, ``conv_bc``) are computed
  replicated and enter the heads through one ``copy_to``, so those
  leaves hold their whole gradient; the per-head ``a_log``, ``d_skip``
  and ``dt_bias`` are replicated and sliced by head: each rank's
  gradient is its heads' part.
- mLSTM's ``wqkv`` and ``wif`` are row-parallel over the conv's
  channels: one :func:`repro_torch.comm.scatter_sum` sums the partial q,
  k, v and gates and keeps this rank's heads' (its backward gathers the
  gradient every rank's channels feed); ``if_bias`` is sliced by head.
- sLSTM: ``w_gates`` is column-parallel over ``[i | f | z | o]`` (at
  ``model`` = 4 a rank holds one whole gate), so ``gather_from`` rebuilds
  the input gates and every model rank runs the whole recurrence with
  the replicated ``r_gates``, ``gate_bias`` and ``norm``; ``out_proj``
  is column-parallel, its blocks gathered. No collective runs inside
  the time loop.

Caches over process ranks (prefill and decode): each process holds the
block of every cache leaf that the JAX package's ``cache_specs`` give it
(``registry.init_caches(..., ranks=)``), its data rows of the batch and,
along the heads or channels, either just its rank's part (**owned**) or
every rank's (**kept whole**: the specs put heads on ``model`` only where
16 divides them). A rank reads its part of a block (:func:`_read_own`)
and writes its new part: in place where the block is owned; where the
block is kept whole, the parts of every such leaf of the layer are
gathered over ``model`` in one ``all_gather`` and written whole, so no
rank leaves another's slots stale (:func:`_write_own`).

- Mamba2: ``ssm`` (heads) owned where 16 divides the heads (Zamba2-1.2B's
  64), else kept whole and gathered; ``conv_x`` (channels) the rank's
  heads' ``x`` channels, owned; ``conv_bc`` replicated, every rank
  writing the whole window it computes replicated.
- mLSTM: ``C``, ``n``, ``m`` (heads) owned or kept whole by the same rule
  (xLSTM-125M's 4 heads: kept whole); ``conv`` (channels) owned.
- sLSTM: ``c``, ``n``, ``h``, ``m`` (heads). Every model rank runs the
  whole recurrence: a block kept whole is read and written as it is, no
  collective; an owned block (16 dividing the heads) is gathered over
  ``model`` before the recurrence (one ``all_gather``) and the rank
  writes its heads back.

The prefill starts the chunked scan (the sLSTM loop) from the block's
state, a decode step (``L == 1``) takes the recurrent step on the rank's
heads, and the conv windows are read from and written to the rank's
channels.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.comm import (axis_position, copy_to, exchange,
                              gather_from, model_parallel, scatter_sum)
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, Params, dense_init,
                                       enter_parallel, parallel_product,
                                       rms_norm, rms_norm_parallel,
                                       row_parallel, silu)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) op by op."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def tp_heads(cfg: ModelConfig, kind: str, model: int) -> int:
    """The heads a rank runs of a recurrent block (``"mamba"``,
    ``"mlstm"``, ``"slstm"``) on a ``model`` axis of ``model`` ranks;
    raises where the heads do not split over them."""
    H = {"mamba": lambda: mamba2_dims(cfg)[1],
         "mlstm": lambda: mlstm_dims(cfg)[1],
         "slstm": lambda: slstm_heads(cfg)[0]}[kind]()
    if H % model:
        raise ValueError(f"{cfg.arch_id}: {H} {kind} heads do not split "
                         f"over {model} ranks of the model axis")
    return H // model


def zx_plan(d_in: int, model: int, rank: int):
    """The ``[z | x]`` exchange of model rank ``rank``: ``(pieces, send,
    recv)``. Cut into ``2 model`` pieces of ``d_in / model`` columns,
    piece ``k`` is the z (``k < model``) or the x of the heads of rank
    ``k % model``; rank ``r``'s column block holds pieces ``2r`` and
    ``2r + 1`` (at ``model`` = 4 ranks 0-1 hold only z), which it sends
    in ``pieces``' order (ascending destination), ``send[j]`` columns to
    rank ``j``; it receives ``recv[i]`` from rank ``i``, its z from a
    lower rank than its x, so the result is its heads' ``[z | x]``."""
    w = d_in // model
    pieces = [k for _, k in sorted((k % model, k)
                                   for k in (2 * rank, 2 * rank + 1))]
    send, recv = [0] * model, [0] * model
    for k in pieces:
        send[k % model] += w
    for k in (rank, model + rank):
        recv[k // 2] += w
    return pieces, send, recv


def _zx_heads(ranks, zx: torch.Tensor, d_in: int) -> torch.Tensor:
    """This rank's column block of a ``[z | x]`` product (``2 d_in``
    columns cut into equal blocks over ``model``) exchanged into its
    heads' ``[z | x]`` (``d_in / model`` channels of each):
    :func:`zx_plan`."""
    r = axis_position(ranks, "model")
    pieces, send, recv = zx_plan(d_in, ranks.axis_size("model"), r)
    if pieces != [2 * r, 2 * r + 1]:
        w = d_in // len(send)
        zx = torch.cat([zx[..., (k - 2 * r) * w:(k - 2 * r + 1) * w]
                        for k in pieces], dim=-1)
    return exchange(ranks, zx, send, recv, "model", -1)


def _head_block(t: torch.Tensor, ranks, per_rank: int) -> torch.Tensor:
    """This rank's heads' entries of a per-head vector."""
    r = axis_position(ranks, "model")
    return t[..., r * per_rank:(r + 1) * per_rank]


def _write(cache: Dict, new: Dict) -> Dict:
    """Copy ``new``'s states into ``cache``'s tensors, in place."""
    for k, v in new.items():
        cache[k].copy_(v)
    return cache


def _read_own(ranks, block: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """This rank's ``n`` heads or channels along ``dim`` of its cache
    ``block``: the block itself where it holds just those (owned), else
    the rank's slice of a block that keeps every rank's."""
    if block.shape[dim] == n:
        return block
    return block.narrow(dim, axis_position(ranks, "model") * n, n)


def _write_own(ranks, cache: Dict, new: Dict) -> Dict:
    """Write this rank's new states into its cache blocks, in place:
    ``new`` is ``{leaf: (the rank's part, the dim of its heads or
    channels)}``. An owned block takes its part as it is; the parts of
    the blocks that keep every rank's are gathered over ``model`` in one
    ``all_gather`` (float32: every leaf's dtype converts exactly) and
    written whole."""
    m = ranks.axis_size("model")
    whole = []
    for k, (t, d) in new.items():
        held = cache[k].shape[d]
        if held == t.shape[d]:
            cache[k].copy_(t)
        elif held == m * t.shape[d]:
            whole.append(k)
        else:
            raise ValueError(f"a cache block of {held} along dim {d} of "
                             f"{k!r} against the rank's {t.shape[d]} over "
                             f"{m} model ranks")
    if not whole:
        return cache
    parts = [new[k][0].movedim(new[k][1], 0) for k in whole]
    flat = torch.cat([p.float().reshape(-1) for p in parts])
    every = gather_from(ranks, flat, "model", 0).reshape(m, -1)
    off = 0
    for k, p in zip(whole, parts):
        full = every[:, off:off + p.numel()].reshape(
            (m * p.shape[0],) + tuple(p.shape[1:]))
        cache[k].copy_(full.movedim(0, new[k][1]))
        off += p.numel()
    return cache


# =============================== Mamba2 (SSD) ===================================


def mamba2_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    head_p = 64
    n_heads = max(d_in // head_p, 1)
    head_p = d_in // n_heads
    return d_in, n_heads, head_p


class Mamba2(Params):
    """``mamba2_init``'s split projections: ``in_zx`` ``(d, 2 d_in)`` [z |
    x], ``in_bcdt`` ``(d, 2N + H)`` [B | C | dt], the depthwise convs
    ``conv_x`` ``(K, d_in)`` and ``conv_bc`` ``(K, 2N)`` with their
    biases, ``out_proj`` ``(d_in, d)`` (all bfloat16: the JAX package casts
    them so before use); ``a_log``, ``d_skip``, ``dt_bias`` ``(H,)`` and
    ``norm`` ``(d_in,)`` float32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_in, H, _ = mamba2_dims(cfg)
        N, K = cfg.ssm_state, cfg.conv_kernel
        self.add("in_zx", (d, 2 * d_in), COMPUTE_DTYPE, device,
                 spec=(None, "model"))
        self.add("in_bcdt", (d, 2 * N + H), COMPUTE_DTYPE, device,
                 spec=(None, None))
        self.add("conv_x", (K, d_in), COMPUTE_DTYPE, device,
                 spec=(None, "model"))
        self.add("conv_x_b", (d_in,), COMPUTE_DTYPE, device, spec=("model",))
        self.add("conv_bc", (K, 2 * N), COMPUTE_DTYPE, device,
                 spec=(None, None))
        self.add("conv_bc_b", (2 * N,), COMPUTE_DTYPE, device, spec=(None,))
        self.add("a_log", (H,), torch.float32, device, spec=(None,))
        self.add("d_skip", (H,), torch.float32, device, spec=(None,))
        self.add("dt_bias", (H,), torch.float32, device, spec=(None,))
        self.add("norm", (d_in,), torch.float32, device, spec=("model",))
        self.add("out_proj", (d_in, d), COMPUTE_DTYPE, device,
                 spec=("model", None))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        H = self.a_log.shape[0]
        dense_init(self.in_zx, generator)
        dense_init(self.in_bcdt, generator)
        dense_init(self.conv_x, generator, 0.1)
        dense_init(self.conv_bc, generator, 0.1)
        self.conv_x_b.zero_()
        self.conv_bc_b.zero_()
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, H)))
        self.d_skip.fill_(1.0)
        self.dt_bias.fill_(math.log(math.expm1(1e-2)))
        self.norm.fill_(1.0)
        dense_init(self.out_proj, generator)

    def forward(self, x, cache: Optional[Dict] = None, ranks=None):
        return mamba2_apply(self, x, self.cfg, cache, ranks)


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B,L,C); w: (K,C). state: (B,K-1,C)
    carry. Returns (silu(y), new_state). The K taps are summed in x's
    dtype in the JAX package's order, ``0 + t0 + t1 + ...``, then the
    bias."""
    K = w.shape[0]
    L = x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:L] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + L] * w[i]
    y = y + b
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return silu(y), new_state


def mamba2_apply(params, x, cfg: ModelConfig, cache: Optional[Dict] = None,
                 ranks=None):
    """x: (B, L, d). Returns (y (B,L,d), cache). ``ranks`` holding
    shards: the model-parallel forward of the module docstring, over this
    process's cache blocks where there is a cache."""
    if model_parallel(ranks):
        return _mamba2_parallel(params, x, cfg, ranks, cache)
    B, L, _ = x.shape
    d_in, H, Pdim = mamba2_dims(cfg)
    N = cfg.ssm_state
    xc = x.to(COMPUTE_DTYPE)
    zx = xc @ params["in_zx"].to(COMPUTE_DTYPE)
    z, xi = zx[..., :d_in], zx[..., d_in:]
    bcdt = xc @ params["in_bcdt"].to(COMPUTE_DTYPE)
    bc, dt_raw = bcdt[..., :2 * N], bcdt[..., 2 * N:]
    xi, new_conv_x = _causal_conv(
        xi, params["conv_x"].to(COMPUTE_DTYPE),
        params["conv_x_b"].to(COMPUTE_DTYPE),
        cache["conv_x"] if cache is not None else None)
    bc, new_conv_bc = _causal_conv(
        bc, params["conv_bc"].to(COMPUTE_DTYPE),
        params["conv_bc_b"].to(COMPUTE_DTYPE),
        cache["conv_bc"] if cache is not None else None)
    xs = xi.reshape(B, L, H, Pdim)
    Bs = bc[..., :N]
    Cs = bc[..., N:]
    dt = softplus(dt_raw.float() + params["dt_bias"])         # (B,L,H)
    A = -torch.exp(params["a_log"])                           # (H,) negative

    if L == 1 and cache is not None:
        y, new_ssm = _ssd_step(xs[:, 0], Bs[:, 0], Cs[:, 0], dt[:, 0], A,
                               params["d_skip"], cache["ssm"])
        y = y[:, None]
    else:
        y, new_ssm = _ssd_chunked(
            xs, Bs, Cs, dt, A, params["d_skip"], cfg.chunk_size,
            cache["ssm"] if cache is not None else None)
    y = y.reshape(B, L, d_in)
    y = rms_norm(y * silu(z.float()).to(COMPUTE_DTYPE), params["norm"],
                 cfg.norm_eps)
    out = y @ params["out_proj"].to(COMPUTE_DTYPE)
    if cache is not None:
        _write(cache, {"ssm": new_ssm, "conv_x": new_conv_x,
                       "conv_bc": new_conv_bc})
    return out, cache


def _mamba2_parallel(params, x, cfg: ModelConfig, ranks,
                     cache: Optional[Dict] = None):
    """Mamba2 over the replicated ``x`` on a process holding its shards
    (the module docstring); the output is replicated. ``cache``: this
    process's blocks, read and written as the module docstring says.
    Returns (y, cache)."""
    B, L, _ = x.shape
    d_in, H, Pdim = mamba2_dims(cfg)
    N = cfg.ssm_state
    heads = tp_heads(cfg, "mamba", ranks.axis_size("model"))
    w = heads * Pdim
    xc = x.to(COMPUTE_DTYPE)
    zx = parallel_product(enter_parallel(ranks, xc), params["in_zx"])
    z, xi = _zx_heads(ranks, zx, d_in).chunk(2, dim=-1)
    bcdt = xc @ params["in_bcdt"].to(COMPUTE_DTYPE)
    bc, dt_raw = bcdt[..., :2 * N], bcdt[..., 2 * N:]
    xi, new_conv_x = _causal_conv(
        xi, params["conv_x"].to(COMPUTE_DTYPE),
        params["conv_x_b"].to(COMPUTE_DTYPE),
        None if cache is None else _read_own(ranks, cache["conv_x"], 2, w))
    bc, new_conv_bc = _causal_conv(
        bc, params["conv_bc"].to(COMPUTE_DTYPE),
        params["conv_bc_b"].to(COMPUTE_DTYPE),
        None if cache is None else cache["conv_bc"])
    # B, C and dt feed every head: their gradient summed over model
    shared = copy_to(ranks, torch.cat([bc, dt_raw], dim=-1).float(), "model")
    Bs, Cs, dt_all = shared.split([N, N, H], dim=-1)
    dt = softplus(_head_block(dt_all, ranks, heads)
                  + _head_block(params["dt_bias"], ranks, heads))
    A = -torch.exp(_head_block(params["a_log"], ranks, heads))
    d_skip = _head_block(params["d_skip"], ranks, heads)
    xs = xi.reshape(B, L, heads, Pdim)
    state = None if cache is None else _read_own(ranks, cache["ssm"], 1,
                                                 heads)
    if L == 1 and cache is not None:
        y, new_ssm = _ssd_step(xs[:, 0], Bs[:, 0], Cs[:, 0], dt[:, 0], A,
                               d_skip, state)
        y = y[:, None]
    else:
        y, new_ssm = _ssd_chunked(xs, Bs, Cs, dt, A, d_skip, cfg.chunk_size,
                                  state)
    y = y.reshape(B, L, w)
    y = rms_norm_parallel(ranks, y * silu(z.float()).to(COMPUTE_DTYPE),
                          params["norm"], cfg.norm_eps, d_in)
    out = row_parallel(ranks, y, params["out_proj"])
    if cache is not None:
        _write_own(ranks, cache, {"ssm": (new_ssm, 1),
                                  "conv_x": (new_conv_x, 2),
                                  "conv_bc": (new_conv_bc, 2)})
    return out, cache


def _ssd_step(x, Bv, Cv, dt, A, d_skip, state):
    """One decode step. x: (B,H,P); Bv/Cv: (B,N); dt: (B,H); state
    (B,H,P,N). Returns (y, new state)."""
    decay = torch.exp(dt * A)                                 # (B,H)
    xf = x.float()
    dx = dt[..., None] * xf                                   # (B,H,P)
    upd = dx[..., None] * Bv[:, None, None, :].float()
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cv.float())
    y = y + d_skip[None, :, None] * xf
    return y.to(COMPUTE_DTYPE), state


def _intra_decay(w, upper, cb, dt):
    """``where(upper, 0, exp(w)) * cb * dt``, the chunk's decay weights,
    as ``exp(where(upper, -inf, w)) * cb * dt``: the same bits (``exp(-inf)``
    is 0), but the upper triangle's ``w`` (the decay from later positions,
    up to ``+200`` at Zamba2-1.2B's chunk of 256) never reaches ``exp``.
    The JAX package's ``jnp.where(tri, jnp.exp(diff), 0.0)`` overflows to
    inf there, and its gradient takes ``0 * inf``: NaN gradients from the
    first step at full width. Without gradients (serving) in ``w``'s own
    buffer, so that no second (B,C,Q,Q,H) float32 buffer exists; with
    gradients out of place, since autograd keeps ``exp``'s output for the
    backward. Both round every op alike, so they give the same bits."""
    if not torch.is_grad_enabled():
        w.masked_fill_(upper, float("-inf"))
        w.exp_()
        return w.mul_(cb).mul_(dt)
    return torch.exp(w.masked_fill(upper, float("-inf"))) * cb * dt


def _ssd_chunked(xs, Bs, Cs, dt, A, d_skip, Q: int, init_state=None):
    """Chunked SSD (Mamba2). xs: (B,L,H,P); Bs/Cs: (B,L,N); dt: (B,L,H).
    ``L`` is padded to a multiple of ``Q``; the loop over chunks carries
    the state, each chunk reading the state *before* it. Returns (y
    (B,L,H,P), final_state (B,H,P,N)). The (B,C,Q,Q,H) float32 decay is
    built by :func:`_intra_decay`."""
    B, L, H, Pdim = xs.shape
    N = Bs.shape[-1]
    pad = (-L) % Q
    if pad:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, 0, 0, pad))
        Bs = torch.nn.functional.pad(Bs, (0, 0, 0, pad))
        Cs = torch.nn.functional.pad(Cs, (0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    Lp = L + pad
    C = Lp // Q
    xs_c = xs.reshape(B, C, Q, H, Pdim).float()
    Bs_c = Bs.reshape(B, C, Q, N).float()
    Cs_c = Cs.reshape(B, C, Q, N).float()
    dt_c = dt.reshape(B, C, Q, H).float()

    a = dt_c * A                                              # (B,C,Q,H)
    cum_a = torch.cumsum(a, dim=2)
    # intra-chunk: decay[t,s] = exp(cum_a[t] - cum_a[s]) for t >= s
    w = cum_a[:, :, :, None, :] - cum_a[:, :, None, :, :]     # (B,C,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xs.device))
    cb = torch.einsum("bctn,bcsn->bcts", Cs_c, Bs_c)          # (B,C,Q,Q)
    w = _intra_decay(w, ~tri[None, None, :, :, None], cb[..., None],
                     dt_c[:, :, None, :, :])
    del cb
    y = torch.einsum("bctsh,bcshp->bcthp", w, xs_c)
    del w

    # per-chunk state contribution: sum_s exp(cumQ - cum_a[s]) dt_s B_s x_s
    decay_out = torch.exp(cum_a[:, :, -1:, :] - cum_a)        # (B,C,Q,H)
    sx = xs_c * (dt_c * decay_out)[..., None]                 # (B,C,Q,H,P)
    s_local = torch.einsum("bcqhp,bcqn->bchpn", sx, Bs_c)     # (B,C,H,P,N)
    del sx
    chunk_decay = torch.exp(cum_a[:, :, -1, :])               # (B,C,H)

    state = (torch.zeros((B, H, Pdim, N), dtype=torch.float32,
                         device=xs.device)
             if init_state is None else init_state.float())
    prev_states = torch.empty_like(s_local)
    for c in range(C):
        prev_states[:, c] = state
        state = state * chunk_decay[:, c, :, None, None] + s_local[:, c]

    # inter-chunk: y_t += C_t . (exp(cum_a[t]) * S_prev)
    c_decay = torch.exp(cum_a)                                # (B,C,Q,H)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cs_c, prev_states) \
        * c_decay[..., None]
    y = y + y_inter + d_skip[None, None, None, :, None] * xs_c
    y = y.reshape(B, Lp, H, Pdim)[:, :L]
    return y.to(COMPUTE_DTYPE), state


def mamba2_init_cache(cfg: ModelConfig, batch: int, device=None) -> Dict:
    d_in, H, Pdim = mamba2_dims(cfg)
    N = cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, H, Pdim, N), dtype=torch.float32,
                           device=device),
        "conv_x": torch.zeros((batch, cfg.conv_kernel - 1, d_in),
                              dtype=COMPUTE_DTYPE, device=device),
        "conv_bc": torch.zeros((batch, cfg.conv_kernel - 1, 2 * N),
                               dtype=COMPUTE_DTYPE, device=device),
    }


# ================================= mLSTM ========================================


def mlstm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or cfg.n_heads
    Pdim = d_in // H
    return d_in, H, Pdim


class MLSTM(Params):
    """``mlstm_init``'s names: ``up_proj`` ``(d, 2 d_in)`` [z, x],
    ``conv_w`` ``(K, d_in)``, ``conv_b``, ``wqkv`` ``(d_in, 3 d_in)``,
    ``wif`` ``(d_in, 2H)``, ``down_proj`` ``(d_in, d)`` (bfloat16);
    ``if_bias`` ``(2H,)`` and ``norm`` ``(d_in,)`` float32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_in, H, _ = mlstm_dims(cfg)
        self.add("up_proj", (d, 2 * d_in), COMPUTE_DTYPE, device,
                 spec=(None, "model"))
        self.add("conv_w", (cfg.conv_kernel, d_in), COMPUTE_DTYPE, device,
                 spec=(None, "model"))
        self.add("conv_b", (d_in,), COMPUTE_DTYPE, device, spec=("model",))
        self.add("wqkv", (d_in, 3 * d_in), COMPUTE_DTYPE, device,
                 spec=("model", None))
        self.add("wif", (d_in, 2 * H), COMPUTE_DTYPE, device,
                 spec=("model", None))
        self.add("if_bias", (2 * H,), torch.float32, device, spec=(None,))
        self.add("norm", (d_in,), torch.float32, device, spec=("model",))
        self.add("down_proj", (d_in, d), COMPUTE_DTYPE, device,
                 spec=("model", None))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        H = self.if_bias.shape[0] // 2
        dense_init(self.up_proj, generator)
        dense_init(self.conv_w, generator, 0.1)
        self.conv_b.zero_()
        dense_init(self.wqkv, generator)
        dense_init(self.wif, generator, 0.02)
        self.if_bias[:H] = 0.0
        self.if_bias[H:] = 3.0
        self.norm.fill_(1.0)
        dense_init(self.down_proj, generator)

    def forward(self, x, cache: Optional[Dict] = None, ranks=None):
        return mlstm_apply(self, x, self.cfg, cache, ranks)


def _mlstm_chunked(q, k, v, log_i, log_f, Q: int, init_state=None):
    """Stabilized chunk-parallel mLSTM. q,k,v: (B,L,H,P); log_i/log_f:
    (B,L,H). Quadratic only within chunks of length Q; the loop carries
    the stabilized matrix state across chunks. Without ``init_state`` the
    stabilizer starts at -1e30 (``mlstm_init_cache`` starts it at 0).
    Padding gives ``log_i`` -1e30 and ``log_f`` 0. Returns (y (B,L,H,P)
    bfloat16, state dict {C, n, m})."""
    B, L, H, Pd = q.shape
    pad = (-L) % Q
    if pad:
        F = torch.nn.functional
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    Lp = L + pad
    C = Lp // Q
    qc = (q.float() * (Pd ** -0.5)).reshape(B, C, Q, H, Pd)
    kc = k.float().reshape(B, C, Q, H, Pd)
    vc = v.float().reshape(B, C, Q, H, Pd)
    lic = log_i.float().reshape(B, C, Q, H)
    lfc = log_f.float().reshape(B, C, Q, H)

    if init_state is None:
        Cm = torch.zeros((B, H, Pd, Pd), dtype=torch.float32, device=q.device)
        nv = torch.zeros((B, H, Pd), dtype=torch.float32, device=q.device)
        m_prev = torch.full((B, H), -1e30, dtype=torch.float32,
                            device=q.device)
    else:
        Cm, nv, m_prev = init_state["C"], init_state["n"], init_state["m"]

    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    ys = []
    for c in range(C):
        qq, kk, vv = qc[:, c], kc[:, c], vc[:, c]
        li, lf = lic[:, c], lfc[:, c]
        b = torch.cumsum(lf, dim=1)                           # (B,Q,H)
        g = li - b
        localmax = torch.cummax(g, dim=1).values
        m_t = torch.maximum(m_prev[:, None] + b, b + localmax)
        inter_decay = torch.exp(b + m_prev[:, None] - m_t)    # (B,Q,H)
        # intra weights: (B,Q,Q,H) for t >= s
        dlog = b[:, :, None, :] - b[:, None, :, :] + li[:, None, :, :] \
            - m_t[:, :, None, :]
        w = torch.where(tri[None, :, :, None], torch.exp(dlog), 0.0)
        s = torch.einsum("bthp,bshp->btsh", qq, kk)
        sw = s * w
        y_intra = torch.einsum("btsh,bshp->bthp", sw, vv)
        # state layout: Cm[p, n] = sum_s v_p k_n
        y_inter = torch.einsum("bthn,bhpn->bthp", qq, Cm) \
            * inter_decay[..., None]
        n_intra = torch.sum(sw, dim=2)
        n_inter = torch.einsum("bthp,bhp->bth", qq, nv) * inter_decay
        den = torch.maximum(torch.abs(n_intra + n_inter), torch.exp(-m_t))
        ys.append(((y_intra + y_inter) / den[..., None]).to(COMPUTE_DTYPE))

        # end-of-chunk state
        m_end = m_t[:, -1]                                    # (B,H)
        b_end = b[:, -1]
        carry_decay = torch.exp(b_end + m_prev - m_end)
        upd_w = torch.exp(b_end[:, None] - b + li - m_end[:, None])
        Cm = Cm * carry_decay[..., None, None] + torch.einsum(
            "bshp,bshn->bhpn", vv * upd_w[..., None], kk)
        nv = nv * carry_decay[..., None] + torch.einsum(
            "bsh,bshp->bhp", upd_w, kk)
        m_prev = m_end
    y = torch.stack(ys, dim=1).reshape(B, Lp, H, Pd)[:, :L]
    return y, {"C": Cm, "n": nv, "m": m_prev}


def _mlstm_step(q, k, v, log_i, log_f, cache):
    """Recurrent step. q,k,v: (B,H,P); log_i/log_f: (B,H)."""
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(log_f + m, log_i)
    f_eff = torch.exp(log_f + m - m_new)
    i_eff = torch.exp(log_i - m_new)
    kf = k.float()
    vf = v.float()
    C = C * f_eff[..., None, None] + i_eff[..., None, None] \
        * (vf[..., :, None] * kf[..., None, :])               # (B,H,P,P)
    n = n * f_eff[..., None] + i_eff[..., None] * kf
    qf = q.float() * (q.shape[-1] ** -0.5)
    num = torch.einsum("bhpq,bhq->bhp", C, qf)
    den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", n, qf)),
                        torch.exp(-m_new))
    y = num / den[..., None]
    return y.to(COMPUTE_DTYPE), {"C": C, "n": n, "m": m_new}


def mlstm_apply(params, x, cfg: ModelConfig, cache: Optional[Dict] = None,
                ranks=None):
    """x: (B, L, d). Returns (y, cache). ``ranks`` holding shards: the
    model-parallel forward of the module docstring, over this process's
    cache blocks where there is a cache."""
    if model_parallel(ranks):
        return _mlstm_parallel(params, x, cfg, ranks, cache)
    B, L, _ = x.shape
    d_in, H, Pdim = mlstm_dims(cfg)
    up = x.to(COMPUTE_DTYPE) @ params["up_proj"].to(COMPUTE_DTYPE)
    z, xi = up[..., :d_in], up[..., d_in:]
    xi, new_conv = _causal_conv(xi, params["conv_w"].to(COMPUTE_DTYPE),
                                params["conv_b"].to(COMPUTE_DTYPE),
                                cache["conv"] if cache is not None else None)
    qkv = xi @ params["wqkv"].to(COMPUTE_DTYPE)
    q, k, v = [t.reshape(B, L, H, Pdim) for t in torch.chunk(qkv, 3, dim=-1)]
    gates = (xi @ params["wif"].to(COMPUTE_DTYPE)).float() + params["if_bias"]
    log_i = torch.clamp(gates[..., :H], max=15.0)  # exponential input gate
    log_f = log_sigmoid(gates[..., H:])

    if L == 1 and cache is not None:
        y, new_rec = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                 log_f[:, 0], cache)
        y = y[:, None]
    else:
        y, new_rec = _mlstm_chunked(q, k, v, log_i, log_f, cfg.chunk_size,
                                    cache)

    y = y.reshape(B, L, d_in)
    y = rms_norm(y * silu(z.float()).to(COMPUTE_DTYPE), params["norm"],
                 cfg.norm_eps)
    out = y @ params["down_proj"].to(COMPUTE_DTYPE)
    if cache is not None:
        _write(cache, dict(new_rec, conv=new_conv))
    return out, cache


def _mlstm_parallel(params, x, cfg: ModelConfig, ranks,
                    cache: Optional[Dict] = None):
    """mLSTM over the replicated ``x`` on a process holding its shards
    (the module docstring); the output is replicated. ``cache``: this
    process's blocks, read and written as the module docstring says.
    Returns (y, cache)."""
    B, L, _ = x.shape
    d_in, H, Pdim = mlstm_dims(cfg)
    m = ranks.axis_size("model")
    heads = tp_heads(cfg, "mlstm", m)
    w = heads * Pdim
    up = parallel_product(enter_parallel(ranks, x), params["up_proj"])
    z, xi = _zx_heads(ranks, up, d_in).chunk(2, dim=-1)
    xi, new_conv = _causal_conv(
        xi, params["conv_w"].to(COMPUTE_DTYPE),
        params["conv_b"].to(COMPUTE_DTYPE),
        None if cache is None else _read_own(ranks, cache["conv"], 2, w))
    xf = xi.float()
    # this rank's channels' parts of q, k, v and the gates, laid out by
    # the rank whose heads each column is, summed and kept there
    qkv = xf @ params["wqkv"].to(COMPUTE_DTYPE).float()
    gates = xf @ params["wif"].to(COMPUTE_DTYPE).float()
    parts = torch.cat(
        [qkv.reshape(B, L, 3, m, w).movedim(3, 2).reshape(B, L, m, 3 * w),
         gates.reshape(B, L, 2, m, heads).movedim(3, 2).reshape(
             B, L, m, 2 * heads)], dim=-1)
    mine = scatter_sum(ranks, parts, "model", 2).reshape(B, L, -1)
    q, k, v = [t.reshape(B, L, heads, Pdim) for t in
               mine[..., :3 * w].to(COMPUTE_DTYPE).chunk(3, dim=-1)]
    bias = params["if_bias"]
    gates = mine[..., 3 * w:].to(COMPUTE_DTYPE).float() + torch.cat(
        [_head_block(bias[:H], ranks, heads),
         _head_block(bias[H:], ranks, heads)])
    log_i = torch.clamp(gates[..., :heads], max=15.0)
    log_f = log_sigmoid(gates[..., heads:])
    state = None if cache is None else {
        k_: _read_own(ranks, cache[k_], 1, heads) for k_ in ("C", "n", "m")}
    if L == 1 and cache is not None:
        y, new_rec = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                 log_f[:, 0], state)
        y = y[:, None]
    else:
        y, new_rec = _mlstm_chunked(q, k, v, log_i, log_f, cfg.chunk_size,
                                    state)
    y = rms_norm_parallel(ranks, y.reshape(B, L, w)
                          * silu(z.float()).to(COMPUTE_DTYPE),
                          params["norm"], cfg.norm_eps, d_in)
    out = row_parallel(ranks, y, params["down_proj"])
    if cache is not None:
        _write_own(ranks, cache, dict(
            {k_: (t, 1) for k_, t in new_rec.items()}, conv=(new_conv, 2)))
    return out, cache


def mlstm_init_cache(cfg: ModelConfig, batch: int, device=None) -> Dict:
    d_in, H, Pdim = mlstm_dims(cfg)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"C": zeros(batch, H, Pdim, Pdim), "n": zeros(batch, H, Pdim),
            "m": zeros(batch, H),
            "conv": zeros(batch, cfg.conv_kernel - 1, d_in,
                          dtype=COMPUTE_DTYPE)}


# ================================= sLSTM ========================================


def slstm_heads(cfg: ModelConfig):
    H = cfg.ssm_heads or cfg.n_heads
    return H, cfg.d_model // H


class SLSTM(Params):
    """``slstm_init``'s names: ``w_gates`` ``(d, 4d)`` [i, f, z, o] and
    ``out_proj`` ``(d, d)`` bfloat16; the per-head recurrent weights
    ``r_gates`` ``(H, P, 4P)``, ``gate_bias`` ``(4d,)`` and ``norm``
    ``(d,)`` float32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        H, Pd = slstm_heads(cfg)
        self.add("w_gates", (d, 4 * d), COMPUTE_DTYPE, device,
                 spec=(None, "model"))
        self.add("r_gates", (H, Pd, 4 * Pd), torch.float32, device,
                 spec=(None, None, None))
        self.add("gate_bias", (4 * d,), torch.float32, device, spec=(None,))
        self.add("norm", (d,), torch.float32, device, spec=(None,))
        self.add("out_proj", (d, d), COMPUTE_DTYPE, device,
                 spec=(None, "model"))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        d = self.cfg.d_model
        dense_init(self.w_gates, generator)
        dense_init(self.r_gates, generator)            # scale P ** -0.5
        self.gate_bias.zero_()
        self.gate_bias[d:2 * d] = 3.0
        self.norm.fill_(1.0)
        dense_init(self.out_proj, generator)

    def forward(self, x, cache: Optional[Dict] = None, ranks=None):
        return slstm_apply(self, x, self.cfg, cache, ranks)


def slstm_apply(params, x, cfg: ModelConfig, cache: Optional[Dict] = None,
                ranks=None):
    """A loop over time (sLSTM is a true recurrence). x: (B,L,d).
    ``ranks`` holding shards: the input gates and the output gathered
    over ``model`` around the replicated recurrence, from and into this
    process's cache blocks (the module docstring)."""
    B, L, d = x.shape
    tp = model_parallel(ranks)
    if not tp:
        wx = x.to(COMPUTE_DTYPE) @ params["w_gates"].to(COMPUTE_DTYPE)
        y, state = _slstm_scan(params, wx.float() + params["gate_bias"],
                               cfg, cache)
        out = y @ params["out_proj"].to(COMPUTE_DTYPE)
        if cache is not None:
            _write(cache, state)
        return out, cache
    heads = tp_heads(cfg, "slstm", ranks.axis_size("model"))
    wx = gather_from(ranks, parallel_product(enter_parallel(ranks, x),
                                             params["w_gates"]), "model", -1)
    names = ("c", "n", "h", "m")
    owned = cache is not None and cache["c"].shape[1] != slstm_heads(cfg)[0]
    whole = cache
    if owned:          # every rank runs every head: gather the state
        every = gather_from(ranks, torch.stack([cache[k] for k in names]),
                            "model", 2)
        whole = dict(zip(names, every.unbind(0)))
    y, state = _slstm_scan(params, wx.float() + params["gate_bias"], cfg,
                           whole)
    out = gather_from(ranks, parallel_product(enter_parallel(ranks, y),
                                              params["out_proj"]),
                      "model", -1)
    if cache is not None:
        _write(cache, {k: _read_own(ranks, state[k], 1, heads) if owned
                       else state[k] for k in names})
    return out, cache


def _slstm_step(wxt, h, c, n, m, r):
    """One time step of the recurrence: ``wxt`` (B,4,H,P) the input gates,
    ``h``, ``c``, ``n``, ``m`` (B,H,P) the state, ``r`` (H,P,4P). Returns
    the new ``(h, c, n, m)`` and what the step's derivative reads,
    ``(pre_i, fm, i_g, f_g, z_g, o_g)``. The ops and their order are the
    JAX package's (one add for the four gates' pre-activations, ``pre_f
    + m`` once)."""
    B, H, Pd = h.shape
    rh = torch.einsum("bhp,hpq->bhq", h, r).reshape(B, H, 4, Pd)
    pre_i, pre_f, pre_z, pre_o = (wxt + rh.transpose(1, 2)).unbind(1)
    fm = pre_f + m
    m_new = torch.maximum(fm, pre_i)
    i_g = torch.exp(pre_i - m_new)
    f_g = torch.exp(fm - m_new)
    z_g = torch.tanh(pre_z)
    o_g = torch.sigmoid(pre_o)
    c = f_g * c + i_g * z_g
    n = f_g * n + i_g
    h = o_g * c / torch.clamp(n, min=1.0)
    return (h, c, n, m_new), (pre_i, fm, i_g, f_g, z_g, o_g)


def _slstm_loop(wx, r, c, n, h, m):
    """The recurrence over ``wx`` (B,L,4,H,P): ``(hs (B,L,H,P), c, n, h,
    m)``."""
    hs = []
    for t in range(wx.shape[1]):
        (h, c, n, m), _ = _slstm_step(wx[:, t], h, c, n, m, r)
        hs.append(h)
    return torch.stack(hs, dim=1), c, n, h, m


class _SLSTMScan(torch.autograd.Function):
    """:func:`_slstm_loop` as one autograd node, for training: the forward
    runs the same steps unrecorded and saves each step's states and
    gates stacked over time; the backward runs each op's derivative by
    hand, step by step in reverse, as autograd would (``maximum`` halving
    a tie, ``clamp`` passing where ``n >= 1``), and ``r_gates``' gradient
    as one product over every step. Autograd's graph of the loop is
    about 30 nodes a step, whose bookkeeping on the host costs more than
    the step's small launches; the hand-written backward issues none of
    it (float64 checks: ``tests/test_torch_train_dist_ssm.py``)."""

    @staticmethod
    def forward(ctx, wx, r, c, n, h, m):
        states = {"h": [h], "c": [c], "n": [n]}
        gates = [[] for _ in range(6)]
        for t in range(wx.shape[1]):
            (h, c, n, m), g = _slstm_step(wx[:, t], h, c, n, m, r)
            for k, v in (("h", h), ("c", c), ("n", n)):
                states[k].append(v)
            for lst, v in zip(gates, g):
                lst.append(v)
        ctx.save_for_backward(r, *(torch.stack(v, dim=1) for v in
                                   (*states.values(), *gates)))
        return torch.stack(states["h"][1:], dim=1), c, n, h, m

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh, dm):
        r, H_all, C_all, N_all, PI, FM, IG, FG, ZG, OG = ctx.saved_tensors
        B, L1, H, Pd = H_all.shape

        def zero_if_none(g):
            return torch.zeros_like(H_all[:, 0]) if g is None else g
        dc, dn, dh, dm = (zero_if_none(g) for g in (dc, dn, dh, dm))
        dpre = [None] * (L1 - 1)
        for t in range(L1 - 2, -1, -1):
            cp, np_, c2, n2 = C_all[:, t], N_all[:, t], C_all[:, t + 1], \
                N_all[:, t + 1]
            i_g, f_g, z_g, o_g = IG[:, t], FG[:, t], ZG[:, t], OG[:, t]
            if dhs is not None:
                dh = dh + dhs[:, t]
            # h = o_g * c2 / q, q = clamp(n2, min=1)
            q = torch.clamp(n2, min=1.0)
            d_oc = dh / q
            dq = -dh * (o_g * c2) / (q * q)
            do = d_oc * c2
            dc = dc + d_oc * o_g
            dn = dn + torch.where(n2 >= 1.0, dq, 0.0)
            # c2 = f_g * cp + i_g * z_g, n2 = f_g * np + i_g
            df = dc * cp + dn * np_
            di = dc * z_g + dn
            dz = dc * i_g
            dc = dc * f_g
            dn = dn * f_g
            # i_g = exp(pre_i - m_new), f_g = exp(fm - m_new)
            ai, af = di * i_g, df * f_g
            dmn = dm - ai - af
            fm, pre_i = FM[:, t], PI[:, t]
            split = torch.where(fm == pre_i, dmn / 2, dmn)
            dfm = af + torch.where(fm < pre_i, 0.0, split)
            d_pre_i = ai + torch.where(fm > pre_i, 0.0, split)
            dm = dfm                              # fm = pre_f + m
            dpre[t] = torch.stack([d_pre_i, dfm, dz * (1 - z_g * z_g),
                                   do * (1 - o_g) * o_g], dim=1)
            dh = torch.einsum("bhq,hpq->bhp",
                              dpre[t].transpose(1, 2).reshape(B, H, 4 * Pd),
                              r)
        dwx = torch.stack(dpre, dim=1)                       # (B,L,4,H,P)
        dr = torch.einsum("blhp,blhq->hpq", H_all[:, :-1],
                          dwx.transpose(2, 3).reshape(B, L1 - 1, H, 4 * Pd))
        return dwx, dr, dc, dn, dh, dm


def _slstm_scan(params, wx, cfg: ModelConfig, cache: Optional[Dict]):
    """The recurrence over the input gates ``wx`` (B,L,4d) float32 from
    ``cache``'s state (or the initial one), and the normed output:
    (y (B,L,d) bfloat16, final state). With gradients through
    :class:`_SLSTMScan`."""
    B, L, d = wx.shape[0], wx.shape[1], wx.shape[2] // 4
    H, Pd = slstm_heads(cfg)
    wx = wx.reshape(B, L, 4, H, Pd)
    st = cache if cache is not None else slstm_init_cache(cfg, B, wx.device)
    r = params["r_gates"]                                      # (H,P,4P)
    scan = (_SLSTMScan.apply if torch.is_grad_enabled()
            and (wx.requires_grad or r.requires_grad) else _slstm_loop)
    hs, c, n, h, m = scan(wx, r, st["c"], st["n"], st["h"], st["m"])
    y = rms_norm(hs.reshape(B, L, d).to(COMPUTE_DTYPE), params["norm"],
                 cfg.norm_eps)
    return y, {"c": c, "n": n, "h": h, "m": m}


def slstm_init_cache(cfg: ModelConfig, batch: int, device=None) -> Dict:
    H, Pd = slstm_heads(cfg)

    def full(v):
        return torch.full((batch, H, Pd), v, dtype=torch.float32,
                          device=device)
    return {"c": full(0.0), "n": full(1.0), "h": full(0.0), "m": full(0.0)}
