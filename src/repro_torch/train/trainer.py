"""Trainer: the train step (gradient accumulation, AdamW, metrics) for any
registry model, on one device or a stacked rank grid, and its sharded
step over process ranks for every family.

Port of ``repro/train/trainer.py``. The JAX package jits the step and
donates its buffers; here the step runs eagerly and updates parameters
and moments in place under ``torch.no_grad()``. Gradients come from
``torch.autograd.grad`` over the model's parameters in the JAX package's
leaf order; a parameter the loss does not reach gets ``None``, which the
optimizer takes as a zero gradient (as JAX differentiates it).
:func:`make_state_shardings` gives the state's sharding specs as data.

Over process ranks (:class:`repro_torch.comm.ProcessRanks`)
:func:`init_train_state` gives each process exactly its shards of the
parameters (cut by their specs) and of the moments (cut by their ZeRO-1
specs), and :func:`jit_train_step` runs the step the JAX package jits
over a mesh, with every collective explicit: the batch over the data
axes, the decoder model-parallel over ``model`` (the layers'
``copy_to``/``reduce_from``/``gather_from``; GQA, SWA or MLA attention,
the split-dim keys and values gathered by ``gather_heads`` and MLA's
split heads moved by ``exchange``, the MLP or the MoE with its dispatch's ``all_to_all``s; Mamba2 and mLSTM
by head with their ``[z | x]`` exchange, mLSTM's ``scatter_sum`` and the
norms' ``sum_both``, sLSTM's gates gathered; zamba2's shared attention
block at each of its points; the VLM's image tokens in front of the
text; the enc-dec's encoder, and its decoder's cross-attention over the
encoder output, :mod:`repro_torch.models.encdec`), the gradients
reduced over the data axes (a ``reduce_scatter`` to the moment shard
where ZeRO-1 shards a leaf, else a ``psum``), AdamW on the moment shard
and the matching slice of the parameter (with the float32 master copy,
its slice, cut by the moments' specs, and the parameter's slice cast
from it), and the slices all-gathered back.

**A masked loss** (``loss_mask`` in the batch) is the global batch's
masked mean, ``sum(nll * m) / max(sum(m), 1)`` over every data row, as
the JAX package's ``softmax_xent`` computes it over the whole batch: one
``psum`` of the mask's count over the data axes a micro batch, and each
data rank divides its sum by the global count over the data ranks'
number (``loss_count``), so that the mean over data ranks the step takes
of the losses and the gradients is the global one, whatever each rank's
own count.

**Replicated leaves' gradients.** A leaf whose spec names no ``model``
axis is replicated along it. Read outside a model-parallel region (the
norms, on replicated activations; MoE's ``shared_gate``; MLA's
``wq_down``, ``q_norm``, ``wkv_down`` and ``kv_norm``, whose latents
enter the heads through ``copy_to``; Mamba2's ``in_bcdt``, ``conv_bc``
and ``conv_bc_b``, whose B, C and dt enter the heads so; sLSTM's
``r_gates``, ``gate_bias`` and ``norm``, read by the recurrence each
model rank runs whole) every rank's gradient is already the whole one.
Read inside one, each rank's gradient is its own heads', query rows' or
tokens' part of it: the GQA/SWA
attention's replicated weights (every weight of the ``_seq_shard``
branch, ``wk``/``wv`` where one KV head is replicated,
``q_norm``/``k_norm``; zamba2's ``shared_attn.attn`` too, its parts
added over its application points by autograd; the enc-dec's encoder
``attn`` and decoder ``self_attn`` and ``cross_attn``, whose keys and
values each rank computes from all of the encoder output for its own
query rows), the MoE's ``router``,
which each model rank reads on its own block of positions (its only
gradient, through ``moe_aux``), and the per-head vectors each rank
slices its heads from: Mamba2's ``a_log``, ``d_skip`` and ``dt_bias``,
mLSTM's ``if_bias``. The rule
(:func:`partial_over_model`): the gradients of those leaves are summed
over ``model`` once, after the backward (one ``psum`` of them all);
then every ``model`` rank holds each replicated leaf's whole gradient,
equal to the one-process gradient. The routed experts get no gradient
(the dispatch frames their inputs as bytes), so AdamW only decays them.
The VLM's ``img_proj`` acts on replicated activations, outside any
model-parallel region: its gradient is whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.comm import (Ranks, Spec, axis_position, model_parallel,
                              shard_slices, spec_axes)
from repro_torch.models.attention import tp_layout
from repro_torch.models.convert import flatten, named_leaves, unflatten
from repro_torch.models.moe import plan_experts
from repro_torch.models.registry import Model, meta_params
from repro_torch.models.ssm import tp_heads
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         zero1_specs,
                                         init_opt_state)


@dataclasses.dataclass
class TrainState:
    """The JAX package's ``TrainState``: parameters, optimizer state and
    the step count."""
    params: Any
    opt: Any
    step: int = 0


def loss_and_grads(model: Model, params, batch: Dict,
                   ranks: Optional[Ranks] = None,
                   dp_axes: Sequence[str] = ("data",)):
    """``(loss, metrics, grads)``: the training loss, its metrics
    (detached) and ``{name: gradient or None}`` in the JAX package's leaf
    order."""
    leaves = named_leaves(params, model.cfg)
    loss, metrics = model.train_loss(params, batch, ranks, tuple(dp_axes))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, dict(zip(leaves, grads))


def build_train_step(model: Model, opt_cfg: AdamWConfig,
                     ranks: Optional[Ranks] = None,
                     dp_axes: Sequence[str] = ("data",),
                     accum_steps: int = 1):
    """Returns ``train_step(params, opt_state, batch, *, on_grads=None)
    -> (params, opt_state, metrics)``, updating both in place;
    ``on_grads(grads)``, if given, sees ``{name: gradient or None}`` (the
    accumulated float32 gradient with ``accum_steps``) before the
    update.

    With ``accum_steps > 1`` the batch's leading axis must be divisible;
    the gradients of the micro batches are accumulated in float32 as
    ``acc + grad / accum_steps``; the loss returned is the last micro
    batch's and ``metrics`` holds only the optimizer's and the loss, as
    in the JAX package."""

    def train_step(params, opt_state, batch, *,
                   on_grads: Optional[Callable] = None):
        if accum_steps == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch,
                                                  ranks, dp_axes)
        else:
            micro = {k: v.reshape((accum_steps, -1) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for n, p in named_leaves(params, model.cfg).items()}
            for i in range(accum_steps):
                loss, _, grads = loss_and_grads(
                    model, params, {k: v[i] for k, v in micro.items()},
                    ranks, dp_axes)
                for n, g in grads.items():
                    if g is not None:
                        acc[n] = acc[n] + g.float() / accum_steps
                del grads
            grads, metrics = acc, {}
        if on_grads is not None:
            on_grads(grads)
        _, _, opt_metrics = adamw_update(
            opt_cfg, named_leaves(params, model.cfg), grads, opt_state)
        return params, opt_state, dict(metrics, **opt_metrics, loss=loss)

    return train_step


def init_train_state(model: Model, generator: Optional[torch.Generator] = None,
                     device=None, master: bool = False, *,
                     ranks: Optional[Ranks] = None,
                     param_specs: Optional[Mapping[str, Spec]] = None,
                     zero1: bool = True,
                     source: Optional[Mapping[str, Any]] = None
                     ) -> Tuple[Any, Dict]:
    """The training form of the model's parameters (float32, drawn on
    ``device`` from ``generator``) and AdamW's zero state. With
    ``master`` the parameters are bfloat16 (the JAX launcher's
    ``bf16_params``) and the optimizer state holds their float32 master
    copy, the unrounded weights.

    With process ``ranks`` (one row a process), this process's shards
    only, on the ranks' device: each parameter the block its spec gives
    this process of the one-process init (bit for bit), each moment (and
    the master copy) the block of its ZeRO-1 spec
    (:func:`make_state_shardings`). The full weights come from
    ``source``, the JAX package's tree or a flat ``{port name: array}``
    (numpy arrays or memmaps, of which only the block is read, or
    tensors), else are drawn whole from ``generator`` on its device and
    cut."""
    if ranks is None or ranks.rows == ranks.world:
        params = model.init(generator, device, dtype=torch.float32)
        opt = init_opt_state(named_leaves(params, model.cfg), master)
        if master:
            params.trainable(torch.bfloat16)
        return params, opt
    cfg = model.cfg
    p_specs, opt_specs = make_state_shardings(model, _sizes(ranks),
                                              param_specs, zero1, master)
    if source is None:
        if generator is None:
            raise ValueError("process ranks draw the weights from a seeded "
                             "generator or cut them from a source")
        source = named_leaves(model.init(generator, generator.device,
                                         dtype=torch.float32), cfg)
    full = flatten(source)

    def block(leaf: str, spec: Spec) -> torch.Tensor:
        b = ranks.local_shard(full[leaf], spec)
        t = (b.detach().to(torch.float32, copy=True)
             if isinstance(b, torch.Tensor) else
             torch.from_numpy(np.array(b, np.float32)))
        return t.to(ranks.device)

    params = meta_params(cfg)
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    dtype = torch.bfloat16 if master else torch.float32
    for prefix, mod in params.named_modules():
        for name in list(mod._parameters):
            leaf = f"{prefix}.{name}" if prefix else name
            mod._parameters[name] = nn.Parameter(
                block(leaf, p_specs[leaf]).to(dtype), requires_grad=True)
    zeros = {n: torch.zeros(_local_shape(shapes[n], opt_specs["m"][n], ranks),
                            dtype=torch.float32, device=ranks.device)
             for n in p_specs}
    opt = {"m": zeros, "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
           "step": torch.zeros((), dtype=torch.int32, device=ranks.device)}
    if master:
        opt["master"] = {n: block(n, opt_specs["master"][n]) for n in p_specs}
    return params, opt


# -- the sharded step over process ranks --------------------------------------


def _sizes(ranks: Ranks) -> Dict[str, int]:
    return dict(zip(ranks.axes, ranks.shape))


def _local_shape(shape, spec: Spec, ranks: Ranks) -> Tuple[int, ...]:
    """The shape of this process's block of a ``shape`` leaf."""
    blocks = shard_slices(shape, spec, ranks.shape, ranks.axes, ranks.rank)
    return tuple(len(range(n)[sl]) for n, sl in zip(shape, blocks))


#: the per-head vectors of the recurrent blocks, by their block's name
_PER_HEAD = {".mamba.": (".a_log", ".d_skip", ".dt_bias"),
             ".cell.": (".if_bias",)}


#: the attention modules' names: a decoder block's ``attn`` (zamba2's
#: shared block's too, and the enc-dec encoder's), the enc-dec decoder's
#: ``self_attn`` and ``cross_attn``
_ATTENTIONS = (".attn.", ".self_attn.", ".cross_attn.")


def partial_over_model(name: str, spec: Spec, cfg=None) -> bool:
    """The rule of the module docstring: a leaf whose spec names no
    ``model`` axis takes a part of its gradient on each model rank if it
    is a MoE's ``router``, a GQA/SWA attention's (``cfg`` None or not
    MLA; zamba2's ``shared_attn.attn``, the enc-dec's encoder ``attn``
    and decoder ``self_attn`` and ``cross_attn`` among them) or a
    recurrent block's per-head vector (Mamba2's ``a_log``, ``d_skip``,
    ``dt_bias``; mLSTM's ``if_bias``); MLA's replicated leaves, Mamba2's
    B, C and dt projections, sLSTM's leaves and the VLM's ``img_proj``
    hold their whole gradient."""
    if "model" in spec_axes(spec):
        return False
    dotted = f".{name}"
    if ".moe." in dotted:
        return dotted.endswith(".router")
    for block, vectors in _PER_HEAD.items():
        if block in dotted:
            return dotted.endswith(vectors)
    return (any(a in dotted for a in _ATTENTIONS)
            and (cfg is None or cfg.attn_type != "mla"))


def _rank_batch(batch: Mapping[str, Any], b_specs: Mapping[str, Spec],
                ranks: Ranks, accum_steps: int, i: int) -> Dict:
    """This process's rows of micro batch ``i`` of the global ``batch``
    (the micro batches are the global batch's consecutive blocks, as
    :func:`build_train_step` cuts them), on its device."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % accum_steps:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split into "
                             f"{accum_steps} micro batches")
        n = v.shape[0] // accum_steps
        block = v[i * n:(i + 1) * n]
        block = ranks.local_shard(block, b_specs[k])
        t = (block if isinstance(block, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(block)))
        out[k] = t.to(ranks.device)
    return out


def _blocks(meta) -> list:
    """The model's blocks: a decoder's layers and zamba2's shared block,
    or the enc-dec's encoder and decoder layers."""
    if "enc_blocks" in meta:
        return list(meta.enc_blocks) + list(meta.dec_blocks)
    return list(meta.blocks) + ([meta.shared_attn] if "shared_attn" in meta
                                else [])


def check_grid_layout(cfg, model: int, meta=None) -> None:
    """Raise ``ValueError`` where the model of ``cfg`` cannot be laid out
    over a ``model`` axis of ``model`` ranks; ``meta``: its
    :func:`meta_params`. Every attention takes one of
    :func:`repro_torch.models.attention.tp_layout`'s layouts (by heads,
    split-dim KV, MLA's split heads, by sequence). What raises: KV heads
    that neither split whole over ``model`` nor divide it, MLA columns
    that do not divide into ``model`` blocks, Mamba2, mLSTM or sLSTM
    heads that ``model`` does not divide
    (:func:`repro_torch.models.ssm.tp_heads`: xLSTM-125M's 4 at 8 or
    16), experts padded otherwise for ``model`` expert ranks than for
    the weights, and encoder frames that the sequence layout does not
    split over ``model`` (Whisper-small's 1500 over 8 or 16)."""
    meta = meta_params(cfg) if meta is None else meta
    for block in _blocks(meta):
        attns = [a for a in ("attn", "self_attn", "cross_attn")
                 if a in block]
        for a in attns:
            tp_layout(cfg, block[a], model)
        if not attns:
            tp_heads(cfg, block.kind, model)
        if "moe" in block:
            plan_experts(cfg, block.moe.w_gate.shape[0], model)
    if cfg.family == "audio" and cfg.enc_seq % model and tp_layout(
            cfg, meta.enc_blocks[0].attn, model) == "sequence":
        raise ValueError(f"{cfg.arch_id}: {cfg.enc_seq} encoder frames "
                         f"do not split over {model} model ranks of the "
                         f"sequence-parallel attention")


def _loss_count(ranks: Ranks, dp: Tuple[str, ...], micro: Mapping,
                dsize: int) -> torch.Tensor:
    """The divisor of this data rank's masked loss: the micro batch's
    global ``max(sum(loss_mask), 1)`` (one ``psum`` over the data axes)
    over the ``dsize`` data ranks."""
    local = micro["loss_mask"].float().sum().reshape(1, 1)
    total = ranks.psum(local, dp).reshape(())
    return torch.clamp(total, min=1.0) / dsize


def _rank_zero_on(ranks: Ranks, spec: Spec) -> bool:
    """Whether this process is the first of those holding the same block
    under ``spec`` (index 0 on every axis the spec does not name)."""
    named = spec_axes(spec)
    return all(c == 0 for a, c in zip(ranks.axes, ranks.coords)
               if a not in named)


def jit_train_step(model: Model, opt_cfg: AdamWConfig, ranks: Ranks,
                   param_specs: Optional[Mapping[str, Spec]] = None,
                   batch_specs: Optional[Mapping[str, Spec]] = None,
                   dp_axes: Sequence[str] = ("data",), accum_steps: int = 1,
                   zero1: bool = True):
    """The JAX package's ``jit_train_step``: ``(step_fn, (param specs,
    optimizer state specs, batch specs))``.

    On stacked :class:`repro_torch.comm.Ranks` the state is global and
    ``step_fn`` is :func:`build_train_step`'s. On process ranks it is the
    sharded step of the module docstring over the state
    :func:`init_train_state` gives the process: ``step_fn(params,
    opt_state, batch, *, on_grads=None) -> (params, opt_state,
    metrics)``, in place, ``batch`` the global batch (each process takes
    its rows by ``batch_specs``, default the model's ``batch_specs`` of
    a training shape over ``dp_axes``; a ``loss_mask`` without a spec of
    its own is cut as ``labels``). The
    loss is the global batch's mean (the last micro batch's with
    ``accum_steps``; a masked loss the global masked mean, see the module
    docstring), ``grad_norm`` the norm of the whole gradient, each
    distinct shard counted once. ``on_grads(grads, specs)``, if given,
    sees the reduced gradients before the update: each leaf's block under
    its spec in ``specs`` (the moment's under ZeRO-1). An ``opt_state``
    holding the float32 ``master`` copy (``init_train_state(...,
    master=True, ranks=)``) is updated in its slices and the bfloat16
    parameters cast from them.

    Every family: the dense (GQA, SWA, MLA), MoE, SSM (xLSTM) and hybrid
    (zamba2) decoders, the VLM (internvl2) and the enc-dec (whisper),
    the attention by heads, by split-dim KV columns, by MLA's split heads
    or by sequence. What raises: :func:`check_grid_layout`."""
    cfg = model.cfg
    dp = tuple(dp_axes)
    p_specs, opt_specs = make_state_shardings(model, _sizes(ranks),
                                              param_specs, zero1)
    b_specs = dict(model.batch_specs("train_4k", dp) if batch_specs is None
                   else batch_specs)
    specs = (p_specs, opt_specs, b_specs)
    cut_specs = dict(b_specs)
    cut_specs.setdefault("loss_mask", b_specs["labels"])
    if ranks.rows == ranks.world:
        return build_train_step(model, opt_cfg, ranks, dp, accum_steps), specs
    meta = meta_params(cfg)
    tp = model_parallel(ranks)
    if cfg.family == "moe" and not tp:
        raise ValueError(f"{cfg.arch_id}: a MoE over process ranks "
                         f"dispatches through the sphere shuffle over a "
                         f"model axis of more than one rank; {ranks!r}")
    if tp:
        check_grid_layout(cfg, ranks.axis_size("model"), meta)
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    local = {n: _local_shape(shapes[n], sp, ranks)
             for n, sp in p_specs.items()}
    partial = [n for n, sp in p_specs.items()
               if tp and partial_over_model(n, sp, cfg)]
    dsize = ranks.axis_size(dp)
    # ZeRO-1: the dimension a moment's spec shards over data axes where the
    # parameter's does not, and those axes
    zero: Dict[str, Tuple[int, Tuple[str, ...]]] = {}
    for n, sp in p_specs.items():
        msp = opt_specs["m"][n]
        for d, (pe, me) in enumerate(zip(sp + (None,) * len(msp), msp)):
            if pe is None and me is not None and dsize > 1:
                zero[n] = (d, spec_axes((me,)))
    held = {n: opt_specs["m"][n] if n in zero else p_specs[n]
            for n in p_specs}

    def reduce_over_data(n: str, g: torch.Tensor) -> torch.Tensor:
        if dsize == 1:
            return g
        if n not in zero:
            return ranks.psum(g.unsqueeze(0), dp).reshape(g.shape) / dsize
        d, axes = zero[n]
        rest = tuple(a for a in dp if a not in axes)
        if rest:
            g = ranks.psum(g.unsqueeze(0), rest).reshape(g.shape)
        t = ranks.reduce_scatter(g.movedim(d, 0).contiguous().unsqueeze(0),
                                 axes)[0]
        return t.movedim(0, d) / dsize

    def step_fn(params, opt_state, batch, *,
                on_grads: Optional[Callable] = None):
        leaves = named_leaves(params, cfg)
        for n, p in leaves.items():
            if tuple(p.shape) != local[n]:
                raise ValueError(f"{n}: {tuple(p.shape)} is not this "
                                 f"process's shard {local[n]} (spec "
                                 f"{p_specs[n]}): init_train_state(..., "
                                 f"ranks=) gives the shards")
        grads: Dict[str, torch.Tensor] = {}
        for i in range(accum_steps):
            micro = _rank_batch(batch, cut_specs, ranks, accum_steps, i)
            if "loss_mask" in micro and dsize > 1:
                micro["loss_count"] = _loss_count(ranks, dp, micro, dsize)
            loss, metrics, g = loss_and_grads(model, params, micro, ranks,
                                              dp)
            for n, p in leaves.items():
                gi = (g[n].float() if g[n] is not None else
                      torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device))
                if accum_steps == 1:
                    grads[n] = gi
                else:
                    grads[n] = grads.get(n, torch.zeros_like(gi)) + \
                        gi / accum_steps
            del g
        if accum_steps > 1:
            metrics = {}
        # the replicated leaves read inside model-parallel regions
        if partial:
            flat = torch.cat([grads[n].reshape(-1) for n in partial])
            flat = ranks.psum(flat.unsqueeze(0), "model").reshape(-1)
            for n, part in zip(partial, flat.split(
                    [grads[n].numel() for n in partial])):
                grads[n] = part.reshape(grads[n].shape)
        grads = {n: reduce_over_data(n, g) for n, g in grads.items()}
        # each distinct shard's square sum once, added in leaf order
        zero_t = torch.zeros((), dtype=torch.float32, device=ranks.device)
        sq = torch.stack([torch.sum(torch.square(g))
                          if _rank_zero_on(ranks, held[n]) else zero_t
                          for n, g in grads.items()])
        total = 0
        for v in ranks.psum(sq.unsqueeze(0)).reshape(-1):
            total = total + v
        gnorm = torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
        # the loss (and any metric) is the global batch's mean
        names = ["loss"] + [k for k in metrics if k != "loss"]
        vals = torch.stack([(loss if k == "loss" else metrics[k]).float()
                            .reshape(()) for k in names])
        if dsize > 1:
            vals = ranks.psum(vals.unsqueeze(0), dp).reshape(-1) / dsize
        reduced = dict(zip(names, vals.unbind()))
        if on_grads is not None:
            on_grads(grads, held)
        slices = {}
        for n, p in leaves.items():
            t = p.detach()
            if n in zero:
                d, axes = zero[n]
                blk = t.shape[d] // ranks.axis_size(axes)
                t = t.narrow(d, axis_position(ranks, axes) * blk, blk)
            slices[n] = t
        _, _, opt_metrics = adamw_update(opt_cfg, slices, grads, opt_state,
                                         gnorm=gnorm)
        for n, (d, axes) in zero.items():
            t = slices[n].movedim(d, 0).contiguous()
            full = ranks.all_gather(t.unsqueeze(0), axes)
            full = full.reshape((-1,) + tuple(t.shape[1:]))
            leaves[n].detach().copy_(full.movedim(0, d))
        return params, opt_state, dict(reduced, **opt_metrics,
                                       loss=reduced["loss"])

    return step_fn, specs


def gather_leaves(ranks, tensors: Mapping[str, torch.Tensor],
                  specs: Mapping[str, Spec],
                  shapes: Mapping[str, Sequence[int]]
                  ) -> Optional[Dict[str, torch.Tensor]]:
    """A rank grid's shards assembled into the whole leaves on process 0
    (CPU tensors; None on the others): ``tensors`` are this process's
    blocks under ``specs`` of leaves of ``shapes`` (the parameters, the
    moments or the gradients), by name. For checks: one ``gather`` a
    leaf, outside the step."""
    out = {} if ranks.rank == 0 else None
    for n, t in tensors.items():
        parts = ranks.gather_to_first(t)
        if parts is None:
            continue
        full = torch.empty(tuple(shapes[n]), dtype=parts[0].dtype)
        for r, part in enumerate(parts):
            full[shard_slices(shapes[n], specs[n], ranks.shape, ranks.axes,
                              r)] = part
        out[n] = full
    return out


def state_tree(model: Model, params, opt_state: Dict) -> Dict:
    """``{"params": ..., "opt": ...}`` laid out as the JAX package's train
    state (what its launcher checkpoints), stacked layers held as
    :class:`repro_torch.models.convert.Stacked` leaves: no tensor is
    copied."""
    cfg = model.cfg
    opt = {k: (unflatten(v, cfg) if isinstance(v, dict) else v)
           for k, v in opt_state.items()}
    return {"params": unflatten(named_leaves(params, cfg), cfg), "opt": opt}


@torch.no_grad()
def load_state_tree(model: Model, params, opt_state: Dict,
                    tree: Dict) -> None:
    """Copy a tree of :func:`state_tree`'s layout (a restored checkpoint)
    into ``params`` and ``opt_state``, in place: the whole state, or a
    process's blocks (``SectorCheckpointer.restore(..., ranks=)``) into
    that process's shards."""
    own = named_leaves(params, model.cfg)
    for name, v in flatten(tree["params"]).items():
        own[name].copy_(v)
    for key, value in tree["opt"].items():
        if isinstance(value, dict):
            for name, v in flatten(value).items():
                opt_state[key][name].copy_(v)
        else:
            opt_state[key].copy_(value)


def make_state_shardings(model: Model, mesh_shape: Mapping[str, int],
                         param_specs: Optional[Mapping[str, Spec]] = None,
                         zero1: bool = True, master: bool = False):
    """The JAX package's state shardings as specs: ``(param_specs,
    {"m": specs, "v": specs, "step": (), "master": specs})``, by port
    name in the JAX package's leaf order. ``mesh_shape``: ``{axis:
    size}`` of the grid (``make_production_mesh(...).sizes``). With
    ``zero1`` and a ``data`` axis the moments (and the float32 master
    copy, with ``master``) are sharded by :func:`zero1_specs`; else they
    take the parameters' specs. Shapes come from the model on the
    ``meta`` device: nothing is allocated."""
    p_specs = dict(model.param_specs() if param_specs is None
                   else param_specs)
    if zero1 and "data" in mesh_shape:
        shapes = {name: tuple(p.shape) for name, p in
                  meta_params(model.cfg).named_parameters()}
        m_specs = zero1_specs(p_specs, shapes, ("data",), dict(mesh_shape))
    else:
        m_specs = p_specs
    opt = {"m": m_specs, "v": m_specs, "step": ()}
    if master:
        opt["master"] = m_specs
    return p_specs, opt


def state_specs(model: Model, param_specs: Mapping[str, Spec],
                opt_specs: Mapping[str, Any]) -> Dict:
    """:func:`make_state_shardings`' (or :func:`jit_train_step`'s) specs
    laid out as :func:`state_tree` lays out the state: ``{"params": ...,
    "opt": {"m", "v", "step"[, "master"]}}``, the layers of a stacked
    collection as one :class:`repro_torch.models.convert.Stacked` of
    their specs. What a checkpoint saved or restored over process ranks
    is cut by."""
    cfg = model.cfg
    opt = {k: (unflatten(v, cfg) if isinstance(v, dict) else v)
           for k, v in opt_specs.items()}
    return {"params": unflatten(dict(param_specs), cfg), "opt": opt}
