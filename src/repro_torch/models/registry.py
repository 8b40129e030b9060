"""Arch registry: build(config) -> Model bundle.

Port of ``repro/models/registry.py``: every family of ``configs/``. The
decoder-only LMs (``dense`` with GQA/SWA/MLA, ``moe``, ``ssm``,
``hybrid``, ``vlm``) build a :class:`transformer.DecoderLM`; ``audio``
builds an :class:`encdec.EncDec`. The bundle exposes:

  init(generator=None, device=None, dtype=None, ranks=None) -> params
  train_loss(params, batch, ranks=None, dp_axes)     -> (loss, metrics)
  prefill(params, batch, caches, ranks=None, dp_axes) -> (logits, caches)
  decode_step(params, caches, batch, ranks=None, dp_axes)
                                                     -> (logits, caches)
  init_caches(batch, max_len, device=None, ranks=None, dp_axes)
  input_specs(shape_name)      -> {name: (shape, torch dtype)}
  param_specs()                -> {name: spec}
  batch_specs(shape_name, dp)  -> {name: spec}
  cache_specs(shape_name, dp)  -> the caches' layout, a spec a leaf
  batch_cache_specs(batch, dp) -> the same for a batch of ``batch`` rows

``init(dtype=torch.float32)`` gives the training form (every parameter
float32 with a gradient, as the JAX package's ``init``); the default is
the serving form (matrix weights in bfloat16, no gradient). A training
batch holds ``tokens`` and ``labels`` (``img_embeds`` for ``vlm``,
``frames`` for ``audio``; a ``loss_mask`` optionally, and the sharded
step's ``loss_count`` with it). An LM's prefill batch holds ``tokens`` (and
``img_embeds`` for ``vlm``, put in front of the text) and returns the
next-token logits; its decode batch ``tokens`` and ``pos``. The enc-dec
prefill takes ``frames`` and ``tokens`` and returns the logits at every
position, as the JAX package's; its decode takes ``tokens``, ``pos`` and
``enc_out``.

A :class:`repro_torch.comm.Ranks` grid takes the place of the JAX
package's ``mesh`` (``dp_axes`` as there): with an expert axis of more
than one rank, each MoE layer dispatches through the Sphere bucket
shuffle over it. Both serving calls run under
``torch.inference_mode()``; caches are written in place.

The sharding metadata is plain data: a spec is a tuple with one entry per
dimension, ``None``, an axis name or a tuple of names, the entries of
the JAX package's ``PartitionSpec`` (:data:`repro_torch.comm.Spec`).
``param_specs()`` gives the spec the JAX package's ``init`` returns for
each parameter, by port name in :func:`convert.named_leaves` order (a
stacked layer's without the layer axis: :func:`convert.spec_tree` lays
them out as the JAX tree), built on the ``meta`` device, so no weight is
allocated. ``batch_specs`` and ``cache_specs`` are the JAX package's for
the inputs of a shape and for the caches (whose layout is the JAX
package's: a layer-stacked dict or a list of per-layer dicts). A
:class:`repro_torch.comm.ProcessRanks` process cuts its block of a
tensor by its spec (``local_shard``).

Serving over process ranks (a :class:`repro_torch.comm.ProcessRanks`
grid with ``data`` and ``model`` axes, every family): each process holds
its blocks of the weights (``init(..., ranks=)`` draws the whole model
one tensor at a time and keeps its blocks; :func:`process_params` cuts
them from a source), its ``data`` rows of the batch (every data rank the
whole row of a batch of one, which the specs replicate) and its blocks
of every cache leaf as ``batch_cache_specs(batch, dp)`` lays them out
(``init_caches(..., ranks=)`` allocates those blocks only): the
attention caches, the recurrent states and conv windows
(:mod:`repro_torch.models.ssm`), and at a batch of one (not
sliding-window) the attention caches' time blocks over ``dp``
(:class:`repro_torch.models.attention.TimeBlock`). ``prefill`` and
``decode_step`` write the caches' blocks in place and return this
process's rows of the logits over the whole vocabulary (the
vocab-parallel readout gathered over ``model`` once). Not ported, and
raising: the MoE at a batch of one over a ``dp`` axis of more than one
rank (:data:`_MOE_ONE_ROW`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch._subclasses.fake_tensor import unset_fake_temporarily

from repro_torch.comm import (Spec, gather_from, model_parallel,
                              resolve_device, shard_slices, spec_axes)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models import attention, encdec, transformer
from repro_torch.models.convert import jax_order
from repro_torch.models.layers import COMPUTE_DTYPE, param_specs
from repro_torch.models.ssm import mamba2_dims, mlstm_dims

#: why :func:`init_caches` over process ranks refuses the MoE at a batch
#: of one over several data ranks
_MOE_ONE_ROW = ("the MoE at batch 1 over a data axis of more than one rank "
                "is not ported: the row is replicated over {dp}, and the "
                "decode's all_gather of per-expert counts over them would "
                "count it once a data rank")


def _device(device) -> torch.device:
    """``meta`` (shapes only: the engine's cache layout) or a device
    :func:`resolve_device` accepts."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def process_ranks(ranks) -> bool:
    """Whether ``ranks`` are one process's row of a grid of several
    (:class:`repro_torch.comm.ProcessRanks`): the serving calls then hold
    this process's blocks only."""
    return ranks is not None and ranks.rows == 1 and ranks.world > 1


@torch.no_grad()
def process_params(cfg: ModelConfig, ranks, *, generator=None,
                   source=None):
    """The serving form of ``cfg``'s model holding this process's block of
    every parameter (the block its spec gives the process, on
    ``ranks.device``): cut from ``source`` (``{port name: array or
    tensor}`` of the whole model, e.g. ``convert.flatten`` of the JAX
    package's tree; only the block is read), else drawn from
    ``generator`` as ``init`` draws the one-process model, one whole
    tensor at a time on the generator's device, bit for bit the block of
    the one-process weights. An attention layout the grid's ``model``
    axis cannot take raises first (:func:`attention.tp_layout`)."""
    params = meta_params(cfg)
    if "model" in ranks.axes:
        for mod in params.modules():
            if isinstance(mod, (attention.Attention, attention.MLA)):
                attention.tp_layout(cfg, mod, ranks.axis_size("model"))
    for _, mod in params.named_modules():
        for name, p in list(mod._parameters.items()):
            block = shard_slices(p.shape, mod.specs[name], ranks.shape,
                                 ranks.axes, ranks.rank)
            local = torch.empty(p[block].shape, dtype=p.dtype,
                                device=ranks.device)
            new = nn.Parameter(local, requires_grad=False)
            new.global_shape, new.block = tuple(p.shape), block
            mod._parameters[name] = new
    if source is None:
        if generator is None:
            raise ValueError("process ranks draw the weights from a seeded "
                             "generator or cut them from a source")
        params.init_weights(generator)
        return params
    for name, p in params.named_parameters():
        b = source[name][p.block]
        b = b if isinstance(b, torch.Tensor) else torch.from_numpy(
            np.array(b, np.float32))
        p.copy_(b.to(p.dtype))
    return params


def _init(make, cfg: ModelConfig, generator, device, dtype, ranks=None):
    """Random weights drawn on ``device`` (default: the card) from
    ``generator`` (default: torch's global one), one tensor at a time;
    ``dtype=torch.float32`` draws the training form. Process ``ranks``:
    this process's blocks of the serving form (:func:`process_params`;
    the training form over ranks is ``trainer.init_train_state``'s)."""
    if process_ranks(ranks):
        if dtype is not None:
            raise ValueError("over process ranks, init draws the serving "
                             "form; trainer.init_train_state the training "
                             "form")
        return process_params(cfg, ranks, generator=generator)
    params = make(cfg, resolve_device(device))
    if dtype is not None:
        if dtype != torch.float32:
            raise ValueError(f"the training form is float32, not {dtype}")
        params.trainable()
    params.init_weights(generator)
    return params


def meta_params(cfg: ModelConfig):
    """The model of ``cfg`` on the ``meta`` device: its parameters' names,
    shapes and specs, no weight allocated."""
    make = encdec.EncDec if cfg.family == "audio" else transformer.DecoderLM
    return make(cfg, torch.device("meta"))


def _param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """Every parameter's spec in the JAX package's leaf order."""
    specs = param_specs(meta_params(cfg))
    return {name: specs[name] for name in jax_order(specs, cfg)}


def _dp_entry(dp_axes: Sequence[str]) -> Any:
    return tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]


def _dp(b: int, dp_axes: Sequence[str]) -> Any:
    """The batch dimension's entry: the dp axes when the batch shards."""
    return None if b <= 1 else _dp_entry(dp_axes)


def _kv_spec(cfg: ModelConfig, tp: int = 16) -> Optional[str]:
    return "model" if cfg.n_kv_heads % tp == 0 else None


def _layer_cache_spec(cfg: ModelConfig, kind: str, b: int,
                      dp_axes: Sequence[str], shard_t: bool = False
                      ) -> Dict[str, Spec]:
    """One layer's cache specs, the JAX package's
    ``_layer_cache_spec``."""
    bs = _dp(b, dp_axes)
    tspec = _dp_entry(dp_axes) if shard_t else None
    if kind in ("dense", "moe", "shared_attn"):
        if cfg.attn_type == "mla":
            return {"ckv": (bs, tspec, None), "k_rope": (bs, tspec, None),
                    "pos": (bs, tspec)}
        kv = _kv_spec(cfg)
        return {"k": (bs, tspec, kv, None), "v": (bs, tspec, kv, None),
                "pos": (bs, tspec)}
    if kind == "mamba":
        hs = "model" if mamba2_dims(cfg)[1] % 16 == 0 else None
        return {"ssm": (bs, hs, None, None), "conv_x": (bs, None, "model"),
                "conv_bc": (bs, None, None)}
    if kind == "mlstm":
        hs = "model" if mlstm_dims(cfg)[1] % 16 == 0 else None
        return {"C": (bs, hs, None, None), "n": (bs, hs, None),
                "m": (bs, hs), "conv": (bs, None, "model")}
    if kind == "slstm":
        hs = "model" if (cfg.ssm_heads or cfg.n_heads) % 16 == 0 else None
        return {k: (bs, hs, None) for k in ("c", "n", "h", "m")}
    raise ValueError(kind)


def _stacked(specs: Dict[str, Spec]) -> Dict[str, Spec]:
    return {k: (None,) + s for k, s in specs.items()}


def _shape(shape) -> ShapeSpec:
    """A shape's :class:`ShapeSpec`: one of ``SHAPES`` by name, or given
    (another size of a shape, as the dry run's checks trace)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def _batch_specs(cfg: ModelConfig, shape_name,
                 dp: Sequence[str]) -> Dict[str, Spec]:
    """The specs of ``shape_name``'s inputs: the batch over ``dp``."""
    bs = _dp(_shape(shape_name).global_batch, dp)
    specs = {"tokens": (bs, None), "labels": (bs, None), "pos": (bs, None),
             "img_embeds": (bs, None, None), "frames": (bs, None, None),
             "enc_out": (bs, None, None)}
    return {k: specs[k] for k in _input_specs(cfg, shape_name)}


def _shard_t(cfg: ModelConfig, b: int) -> bool:
    """Whether the caches of a batch of ``b`` shard their time axis:
    long-context batches (1 row), not sliding-window."""
    return b == 1 and cfg.attn_type != "swa"


def lm_cache_specs(cfg: ModelConfig, b: int, dp: Sequence[str]):
    """The JAX package's ``cache_specs`` for a batch of ``b`` rows:
    long-context batches (batch 1, not sliding-window) shard the cache's
    time axis over the dp axes."""
    shard_t = _shard_t(cfg, b)
    pattern = transformer.layer_pattern(cfg)
    if transformer.homogeneous(cfg):
        return _stacked(_layer_cache_spec(cfg, pattern[0], b, dp, shard_t))
    specs = [_layer_cache_spec(cfg, k, b, dp, shard_t) for k in pattern]
    for _ in transformer._shared_attn_points(cfg):
        specs.append(_layer_cache_spec(cfg, "shared_attn", b, dp, shard_t))
    return specs


def encdec_cache_specs(cfg: ModelConfig, b: int, dp: Sequence[str]):
    """The enc-dec's ``cache_specs`` for a batch of ``b`` rows: the
    decoder's layer-stacked self-attention caches."""
    return _stacked(_layer_cache_spec(cfg, "dense", b, dp))


def _process_caches(cfg: ModelConfig, batch: int, max_len: int, ranks,
                    dp_axes: Sequence[str], specs, make):
    """This process's blocks of the caches ``make(batch, max_len, "meta")``
    lays out, cut by ``specs`` (the same layout): each leaf allocated at
    its block's shape only and filled as ``make`` fills it (every leaf is
    one value: ``pos`` -1 for empty slots, sLSTM's ``n`` 1, the rest 0;
    read from ``make(1, 1)`` on the CPU). An attention cache whose time
    axis the specs shard over more than one rank is a
    :class:`attention.TimeBlock` over those axes."""
    dp = ranks.axis_size(tuple(dp_axes))
    if cfg.family == "moe" and batch == 1 and dp > 1:
        raise ValueError(f"{cfg.arch_id}: " + _MOE_ONE_ROW.format(
            dp=tuple(dp_axes)))

    def fills(small):
        if isinstance(small, list):
            return [fills(v) for v in small]
        if isinstance(small, dict):
            return {k: fills(v) for k, v in small.items()}
        fill = small.reshape(-1)[0]
        if not bool((small == fill).all()):
            raise ValueError(f"a cache leaf of {cfg.arch_id} is not filled "
                             f"with one value")
        return fill.item()

    def cut(leaf, spec, fill):
        block = shard_slices(leaf.shape, spec, ranks.shape, ranks.axes,
                             ranks.rank)
        return torch.full(leaf[block].shape, fill, dtype=leaf.dtype,
                          device=ranks.device)

    def walk(leaves, specs, fill):
        if isinstance(leaves, list):
            return [walk(*a) for a in zip(leaves, specs, fill)]
        if not isinstance(leaves, dict):
            return cut(leaves, specs, fill)
        out = {k: walk(v, specs[k], fill[k]) for k, v in leaves.items()}
        t = specs["pos"][-1] if "pos" in specs else None
        if t is None or ranks.axis_size(spec_axes((t,))) == 1:
            return out
        return attention.TimeBlock(out, spec_axes((t,)))
    # the fills are read from real tensors, also where a traced program
    # (FakeTensorMode) allocates the caches
    with unset_fake_temporarily():
        values = fills(make(1, 1, torch.device("cpu")))
    return walk(make(batch, max_len, torch.device("meta")), specs, values)


def _whole_vocab(logits, ranks):
    """The serving calls' logits over the whole vocabulary: the
    vocab-parallel readout's columns gathered over ``model``."""
    if model_parallel(ranks):
        return gather_from(ranks, logits, "model", -1)
    return logits


def _input_specs(cfg: ModelConfig, shape_name) -> Dict:
    """The inputs of ``shape_name`` (a name of ``SHAPES`` or a
    :class:`ShapeSpec`) as ``{name: (shape, torch dtype)}``, the JAX
    package's ``input_specs`` without its sharding."""
    sp = _shape(shape_name)
    b, s = sp.global_batch, sp.seq_len
    tok = lambda n: ((b, n), torch.int32)            # noqa: E731
    if cfg.family == "audio":
        frames = ((b, cfg.enc_seq, cfg.d_model), COMPUTE_DTYPE)
        if sp.kind == "train":
            return {"frames": frames, "tokens": tok(s), "labels": tok(s)}
        if sp.kind == "prefill":
            return {"frames": frames, "tokens": tok(s)}
        return {"tokens": tok(1), "pos": tok(1),
                "enc_out": ((b, cfg.enc_seq, cfg.d_model), COMPUTE_DTYPE)}
    if sp.kind == "decode":
        return {"tokens": tok(1), "pos": tok(1)}
    img = cfg.img_tokens if cfg.family == "vlm" else 0
    out = {"tokens": tok(s - img)}
    if sp.kind == "train":
        out["labels"] = tok(s - img)
    if img:
        out["img_embeds"] = ((b, img, cfg.d_model), COMPUTE_DTYPE)
    return out


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init: Callable            # (generator=None, device=None, dtype=None)
    train_loss: Callable      # (params, batch, ranks, dp_axes)
    prefill: Callable         # (params, batch, caches, ranks, dp_axes)
    decode_step: Callable     # (params, caches, batch, ranks, dp_axes)
    init_caches: Callable     # (batch, max_len, device, ranks, dp_axes)
    input_specs: Callable     # (shape_name) -> {name: (shape, dtype)}
    param_specs: Callable     # () -> {name: spec}
    batch_specs: Callable     # (shape_name, dp) -> {name: spec}
    cache_specs: Callable     # (shape_name, dp) -> caches' layout of specs
    batch_cache_specs: Callable  # (batch, dp) -> the same, by batch size


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "audio":
        return _build_encdec(cfg)
    return _build_lm(cfg)


def _build_lm(cfg: ModelConfig) -> Model:
    def init(generator: Optional[torch.Generator] = None, device=None,
             dtype: Optional[torch.dtype] = None, ranks=None):
        return _init(transformer.DecoderLM, cfg, generator, device, dtype,
                     ranks)

    def train_loss(params, batch: Dict, ranks=None, dp_axes=("data",)):
        return transformer.train_loss(params, cfg, batch, ranks, dp_axes)

    @torch.inference_mode()
    def prefill(params, batch: Dict, caches, ranks=None, dp_axes=("data",)):
        # q_pos covers the image embeddings and the text; only the
        # next-token logits are materialised
        logits, caches, _ = transformer.lm_forward(
            params, cfg, batch["tokens"], q_pos=None, caches=caches,
            ranks=ranks, dp_axes=dp_axes,
            img_embeds=batch.get("img_embeds"), last_only=True)
        return _whole_vocab(logits, ranks), caches

    @torch.inference_mode()
    def decode_step(params, caches, batch: Dict, ranks=None,
                    dp_axes=("data",)):
        logits, caches, _ = transformer.lm_forward(
            params, cfg, batch["tokens"], q_pos=batch["pos"], caches=caches,
            ranks=ranks, dp_axes=dp_axes)
        return _whole_vocab(logits, ranks), caches

    def init_caches(batch: int, max_len: int, device=None, ranks=None,
                    dp_axes=("data",)):
        if process_ranks(ranks):
            return _process_caches(
                cfg, batch, max_len, ranks, dp_axes,
                lm_cache_specs(cfg, batch, dp_axes),
                lambda b, t, dev: transformer.init_caches(cfg, b, t, dev))
        return transformer.init_caches(cfg, batch, max_len, _device(device))

    return Model(cfg, init, train_loss, prefill, decode_step, init_caches,
                 lambda shape_name: _input_specs(cfg, shape_name),
                 lambda: _param_specs(cfg),
                 lambda shape_name, dp=("pod", "data"): _batch_specs(
                     cfg, shape_name, dp),
                 lambda shape_name, dp=("pod", "data"): lm_cache_specs(
                     cfg, SHAPES[shape_name].global_batch, dp),
                 lambda batch, dp=("pod", "data"): lm_cache_specs(
                     cfg, batch, dp))


def _build_encdec(cfg: ModelConfig) -> Model:
    def init(generator: Optional[torch.Generator] = None, device=None,
             dtype: Optional[torch.dtype] = None, ranks=None):
        return _init(encdec.EncDec, cfg, generator, device, dtype, ranks)

    def train_loss(params, batch: Dict, ranks=None, dp_axes=("data",)):
        return encdec.train_loss(params, cfg, batch, ranks)

    @torch.inference_mode()
    def prefill(params, batch: Dict, caches, ranks=None, dp_axes=("data",)):
        enc_out = encdec.encode(params, cfg, batch["frames"], ranks)
        logits, caches = encdec.decode_stack(
            params, cfg, batch["tokens"], enc_out, caches=caches, ranks=ranks)
        return _whole_vocab(logits, ranks), caches

    @torch.inference_mode()
    def decode_step(params, caches, batch: Dict, ranks=None,
                    dp_axes=("data",)):
        # the serving path carries the encoder output in the batch
        logits, caches = encdec.decode_stack(
            params, cfg, batch["tokens"], batch["enc_out"],
            q_pos=batch["pos"], caches=caches, ranks=ranks)
        return _whole_vocab(logits, ranks), caches

    def init_caches(batch: int, max_len: int, device=None, ranks=None,
                    dp_axes=("data",)):
        if process_ranks(ranks):
            return _process_caches(
                cfg, batch, max_len, ranks, dp_axes,
                encdec_cache_specs(cfg, batch, dp_axes),
                lambda b, t, dev: encdec.init_caches(cfg, b, t, dev))
        return encdec.init_caches(cfg, batch, max_len, _device(device))

    return Model(cfg, init, train_loss, prefill, decode_step, init_caches,
                 lambda shape_name: _input_specs(cfg, shape_name),
                 lambda: _param_specs(cfg),
                 lambda shape_name, dp=("pod", "data"): _batch_specs(
                     cfg, shape_name, dp),
                 lambda shape_name, dp=("pod", "data"): encdec_cache_specs(
                     cfg, SHAPES[shape_name].global_batch, dp),
                 lambda batch, dp=("pod", "data"): encdec_cache_specs(
                     cfg, batch, dp))
