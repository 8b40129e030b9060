"""Shared building blocks: norms, RoPE, MLPs, embeddings, init helpers.

Port of ``repro/models/layers.py``. For serving, matrix weights are
stored in bfloat16, the dtype every product of the JAX package casts them
to first (``.astype(COMPUTE_DTYPE)``), so storing them so changes no
result and halves their memory; norms stay float32. For training
(:meth:`Params.trainable`) every parameter is float32 and takes a
gradient, as the JAX package's ``init`` draws them; the products cast
them to bfloat16 all the same, so the forward gives the same bits either
way. Products run in bfloat16 with bfloat16 results, norms and softmax
accumulation in float32, as there.

Parameters live in :class:`Params` modules under the JAX package's names
(``w_up``, ``w_down``, ...), so a weight carries across name for name;
the apply functions take any mapping of those names to tensors. Each is
declared with its sharding spec, the JAX package's ``PartitionSpec`` as
a plain tuple (:data:`repro_torch.comm.Spec`): :func:`param_specs` lists
them.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from repro_torch.comm import (Spec, axis_position, copy_to, model_parallel,
                              reduce_from, spec_axes, sum_both)

COMPUTE_DTYPE = torch.bfloat16


class Params(nn.Module):
    """A module whose parameters are read by name, ``p["w_up"]``, like
    the JAX package's parameter dicts. Built for serving, its parameters
    take no gradient; :meth:`trainable` gives the training form."""

    def __init__(self):
        super().__init__()
        #: each own parameter's sharding spec, by name
        self.specs: Dict[str, Spec] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def add(self, name: str, shape, dtype: torch.dtype, device, *,
            spec: Spec) -> None:
        """An uninitialised parameter (``init`` or a carrier fills it) and
        its sharding spec, one entry per dimension as the JAX package's
        ``init`` declares it."""
        if len(spec) != len(shape):
            raise ValueError(f"{name}: spec {spec} for shape {shape}")
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device),
            requires_grad=False))
        self.specs[name] = tuple(spec)

    def trainable(self, dtype: torch.dtype = torch.float32) -> "Params":
        """The training form, in place: every parameter float32 with
        ``requires_grad`` (the values carried over exactly; draw or load
        the weights after this call, so that nothing is rounded to
        bfloat16 first). ``dtype=torch.bfloat16``: every parameter
        rounded to bfloat16, the JAX launcher's ``bf16_params`` form,
        trained against the optimizer's float32 master copy."""
        for mod in self.modules():
            for name, p in list(mod._parameters.items()):
                if p is not None:
                    mod._parameters[name] = nn.Parameter(
                        p.detach().to(dtype), requires_grad=True)
        return self


def param_specs(params: Params) -> Dict[str, Spec]:
    """``{parameter name: spec}`` of a model, in ``named_parameters``
    order."""
    return {f"{prefix}.{name}" if prefix else name: mod.specs[name]
            for prefix, mod in params.named_modules()
            for name in mod._parameters}


@torch.no_grad()
def dense_init(param: torch.Tensor, generator: Optional[torch.Generator],
               scale: Optional[float] = None,
               zero_from: Optional[int] = None) -> None:
    """Fill ``param`` as the JAX package's initialisers draw it: float32
    normals times ``scale`` (``dense_init``'s ``d_in ** -0.5`` by
    default, ``d_in`` the second-to-last axis), rows ``zero_from:`` of
    the first axis zeroed (padded experts, padded vocabulary), then cast
    to the parameter's dtype. Only this one tensor exists in float32, on
    the parameter's device. A parameter that holds one process's block
    (``global_shape`` and ``block`` set on it,
    :func:`repro_torch.models.registry.process_params`) draws the whole
    tensor, so the generator moves as for the whole model, and keeps its
    block."""
    shape = getattr(param, "global_shape", param.shape)
    scale = scale if scale is not None else shape[-2] ** -0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=param.device)
    w *= scale
    if zero_from is not None:
        w[zero_from:] = 0.0
    param.copy_(w[getattr(param, "block", ())])


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(COMPUTE_DTYPE)


def rms_norm_parallel(ranks, x: torch.Tensor, scale: torch.Tensor,
                      eps: float, width: int) -> torch.Tensor:
    """:func:`rms_norm` over a last dimension of ``width`` split over the
    model axis: ``x`` and ``scale`` are this rank's blocks, the mean of
    squares the ranks' square sums added by :func:`repro_torch.comm.
    sum_both` (each rank's gradient of it is its own block's part) over
    ``width``."""
    xf = x.float()
    var = sum_both(ranks, torch.sum(xf * xf, dim=-1, keepdim=True),
                   "model") / width
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(COMPUTE_DTYPE)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the JAX package computes it: ``x * (1 / (1 +
    exp(-x)))``, every step rounded to ``x``'s dtype, as XLA rounds each
    bfloat16 op (a fused ``F.silu`` rounds once, and differs in about a
    third of bfloat16 results)."""
    return x * torch.reciprocal(torch.exp(-x) + 1)


def round_scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float (a scalar operand,
    so that no constant is copied to the card, which waits for it)."""
    return torch.tensor(v, dtype=dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh form) op by op in ``x``'s dtype,
    the constants rounded to it first, as the JAX package computes it."""
    def c(v):
        return round_scalar(v, x.dtype)
    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (torch.tanh(inner) + c(1.0)))


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., :, None].float() * freqs         # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_at(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style sinusoids, float32 ``(..., d_model)``, at float32
    ``positions`` of any shape: ``sin`` then ``cos`` of ``pos * exp(-i *
    log(10000) / (d_model // 2 - 1))``, as the JAX package computes them
    (``log(10000)`` rounded to float32 first)."""
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=positions.device)
    step = round_scalar(math.log(10000.0), torch.float32) / (d_model // 2 - 1)
    inv = torch.exp(-dim * round_scalar(step, torch.float32))
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoid_positions(seq: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (encoder), float32 ``(seq,
    d_model)``."""
    return sinusoid_at(torch.arange(seq, dtype=torch.float32, device=device),
                       d_model)


# -- MLP -----------------------------------------------------------------------


class MLP(Params):
    """SwiGLU (``gated``) or GELU feed-forward: ``w_gate``, ``w_up``
    ``(d_model, d_ff)``, ``w_down`` ``(d_ff, d_model)``; ``init_weights``
    draws as ``mlp_init`` does."""

    def __init__(self, d_model: int, d_ff: int, gated: bool = True,
                 device=None):
        super().__init__()
        self.gated = gated
        if gated:
            self.add("w_gate", (d_model, d_ff), COMPUTE_DTYPE, device,
                     spec=(None, "model"))
        self.add("w_up", (d_model, d_ff), COMPUTE_DTYPE, device,
                 spec=(None, "model"))
        self.add("w_down", (d_ff, d_model), COMPUTE_DTYPE, device,
                 spec=("model", None))

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        if self.gated:
            dense_init(self.w_gate, generator)
        dense_init(self.w_up, generator)
        dense_init(self.w_down, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x, self.gated)


def sharded_dim(params: Params, name: str) -> Optional[int]:
    """The dimension of ``name`` whose spec entry names the ``model``
    axis (None: replicated along it), read from the spec the leaf was
    added with."""
    for dim, entry in enumerate(params.specs[name]):
        if entry is not None and "model" in spec_axes((entry,)):
            return dim
    return None


# The model-parallel products (where the process holds shards,
# :func:`repro_torch.comm.model_parallel`) take their bfloat16 operands
# in float32: each product is exact and the sums run in float32, as a
# bfloat16 product accumulates, so that a sum over ranks adds float32
# parts and rounds once to bfloat16, and so do the gradients.


def enter_parallel(ranks, x: torch.Tensor) -> torch.Tensor:
    """The replicated ``x`` as the float32 input of column-parallel
    products: through ``copy_to``, whose backward sums the products'
    float32 gradients of ``x`` over ``model``, rounded to bfloat16
    once."""
    return copy_to(ranks, x.to(COMPUTE_DTYPE).float(), "model")


def parallel_product(xf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``xf @ w``, ``xf`` from :func:`enter_parallel`, rounded once to
    bfloat16 as a bfloat16 product is."""
    return (xf @ w.to(COMPUTE_DTYPE).float()).to(COMPUTE_DTYPE)


def row_parallel(ranks, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` with ``w`` split by rows over the model axis: this rank's
    partial product of the bfloat16 operands in float32 (each product
    exact, the sum in float32, as a bfloat16 product accumulates), summed
    over ``model`` in float32 by ``reduce_from`` and rounded once to
    bfloat16: the one-process product up to the order of its float32
    additions."""
    part = h.to(COMPUTE_DTYPE).float() @ w.to(COMPUTE_DTYPE).float()
    return reduce_from(ranks, part, "model").to(COMPUTE_DTYPE)


def mlp_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor,
              gated: bool = True, ranks=None) -> torch.Tensor:
    """The MLP over ``x`` (..., d). Where the process holds shards
    (:func:`repro_torch.comm.model_parallel`), its specs make ``w_gate``
    and ``w_up`` column-parallel and ``w_down`` row-parallel: the
    replicated input enters through :func:`enter_parallel` and the
    partial products leave through :func:`row_parallel`."""
    x = x.to(COMPUTE_DTYPE)
    tp = model_parallel(ranks)
    if tp:
        want = {"w_up": 1, "w_down": 0, **({"w_gate": 1} if gated else {})}
        got = {n: sharded_dim(params, n) for n in want}
        if got != want:
            raise ValueError(f"a model-parallel MLP needs the model axis "
                             f"on dimensions {want}; its specs give {got}")
        xf = enter_parallel(ranks, x)
        up = parallel_product(xf, params["w_up"])
        gate = parallel_product(xf, params["w_gate"]) if gated else None
    else:
        up = x @ params["w_up"].to(COMPUTE_DTYPE)
        gate = x @ params["w_gate"].to(COMPUTE_DTYPE) if gated else None
    h = silu(gate) * up if gated else gelu(up)
    if tp:
        return row_parallel(ranks, h, params["w_down"])
    return h @ params["w_down"].to(COMPUTE_DTYPE)


# -- embeddings ------------------------------------------------------------------

VOCAB_PAD = 128  # lane-aligned AND divisible by the model axis (16)


def padded_vocab(vocab: int) -> int:
    return (vocab + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


# Where the process holds shards (:func:`repro_torch.comm.model_parallel`)
# the tied embedding is vocab-parallel: ``embed``'s spec puts the model
# axis on its rows, so a rank holds the ``rows`` ids from ``rank * rows``.


def _vocab_block(ranks, rows: int, ids: torch.Tensor):
    """Each id's row in this rank's vocabulary block, and whether it is
    there (ids outside it point at row 0)."""
    local = ids.long() - axis_position(ranks, "model") * rows
    inside = (local >= 0) & (local < rows)
    return torch.where(inside, local, 0), inside


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor,
                 ranks=None) -> torch.Tensor:
    """The embeddings of ``tokens``. Vocab-parallel: a token outside this
    rank's block gives zeros, and ``reduce_from`` adds the one rank's row
    that holds it (exactly)."""
    if not model_parallel(ranks):
        return emb.to(COMPUTE_DTYPE)[tokens.long()]
    local, inside = _vocab_block(ranks, emb.shape[0], tokens)
    x = emb.to(COMPUTE_DTYPE)[local].masked_fill(~inside[..., None], 0.0)
    return reduce_from(ranks, x, "model")


def lm_logits(emb: torch.Tensor, x: torch.Tensor, cap: float = 0.0,
              vocab: Optional[int] = None, ranks=None) -> torch.Tensor:
    """Tied-embedding readout; float32 logits over the padded vocabulary,
    padding columns at -1e30 so softmax and argmax never see them.
    Vocab-parallel: this rank's block of columns, the padding set on the
    rank that holds it (the replicated ``x`` enters through
    :func:`enter_parallel`)."""
    start = 0
    if model_parallel(ranks):
        start = axis_position(ranks, "model") * emb.shape[0]
        logits = parallel_product(enter_parallel(ranks, x), emb.T).float()
    else:
        logits = (x.to(COMPUTE_DTYPE) @ emb.to(COMPUTE_DTYPE).T).float()
    if cap > 0.0:
        logits = cap * torch.tanh(logits / cap)
    if vocab is not None and vocab < start + emb.shape[0]:
        logits[..., max(vocab - start, 0):] = -1e30
    return logits


def _xent_parallel(logits: torch.Tensor, labels: torch.Tensor, ranks):
    """Vocab-parallel ``logsumexp - gold`` over this rank's columns: the
    global max over the model axis (``pmax``, no gradient), then one
    ``reduce_from`` of the sum of exponentials and of the gold logit,
    which only the rank holding the label adds. The (batch, seq, vocab)
    logits are never gathered."""
    top = logits.detach().amax(dim=-1)
    top = ranks.pmax(top.unsqueeze(0), "model").reshape(top.shape)
    sumexp = torch.exp(logits - top[..., None]).sum(dim=-1)
    local, inside = _vocab_block(ranks, logits.shape[-1], labels)
    gold = torch.gather(logits, -1, local[..., None])[..., 0]
    both = reduce_from(ranks, torch.stack(
        [sumexp, gold.masked_fill(~inside, 0.0)]), "model")
    return top + torch.log(both[0]) - both[1]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 ranks=None, count: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Mean cross-entropy over (optionally masked) positions; float32.
    Vocab-parallel where the process holds shards: ``logits`` are this
    rank's columns (:func:`lm_logits`). ``count``, with a ``mask``: the
    divisor in place of ``max(sum(mask), 1)``. The sharded train step
    gives each data rank the global batch's ``max(sum(mask), 1)`` over
    the data ranks' number, so that their mean loss is the global masked
    mean (:func:`repro_torch.train.trainer.jit_train_step`)."""
    if model_parallel(ranks):
        nll = _xent_parallel(logits, labels, ranks)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = logz - gold
    if mask is not None:
        m = mask.float()
        if count is None:
            count = torch.clamp(torch.sum(m), min=1.0)
        return torch.sum(nll * m) / count
    return torch.mean(nll)
