"""Arch registry: build(config) -> Model bundle.

Port of ``repro/models/registry.py``: every family of ``configs/``. The
decoder-only LMs (``dense`` with GQA/SWA/MLA, ``moe``, ``ssm``,
``hybrid``, ``vlm``) build a :class:`transformer.DecoderLM`; ``audio``
builds an :class:`encdec.EncDec`. The bundle exposes:

  init(generator=None, device=None, dtype=None)      -> params
  train_loss(params, batch, ranks=None, dp_axes)     -> (loss, metrics)
  prefill(params, batch, caches, ranks=None)         -> (logits, caches)
  decode_step(params, caches, batch, ranks=None)     -> (logits, caches)
  init_caches(batch, max_len, device=None)
  input_specs(shape_name)      -> {name: (shape, torch dtype)}
  param_specs()                -> {name: spec}
  batch_specs(shape_name, dp)  -> {name: spec}
  cache_specs(shape_name, dp)  -> the caches' layout, a spec a leaf

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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.comm import Spec, resolve_device
from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.convert import jax_order
from repro_torch.models.layers import COMPUTE_DTYPE, param_specs
from repro_torch.models.ssm import mamba2_dims, mlstm_dims


def _device(device) -> torch.device:
    """``meta`` (shapes only: the engine's cache layout) or a device
    :func:`resolve_device` accepts."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _init(make, cfg: ModelConfig, generator, device, dtype):
    """Random weights drawn on ``device`` (default: the card) from
    ``generator`` (default: torch's global one), one tensor at a time;
    ``dtype=torch.float32`` draws the training form."""
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


def _batch_specs(cfg: ModelConfig, shape_name: str,
                 dp: Sequence[str]) -> Dict[str, Spec]:
    """The specs of ``shape_name``'s inputs: the batch over ``dp``."""
    bs = _dp(SHAPES[shape_name].global_batch, dp)
    specs = {"tokens": (bs, None), "labels": (bs, None), "pos": (bs, None),
             "img_embeds": (bs, None, None), "frames": (bs, None, None),
             "enc_out": (bs, None, None)}
    return {k: specs[k] for k in _input_specs(cfg, shape_name)}


def _lm_cache_specs(cfg: ModelConfig, shape_name: str, dp: Sequence[str]):
    """The JAX package's ``cache_specs``: long-context shapes (batch 1,
    not sliding-window) shard the cache's time axis over the dp axes."""
    b = SHAPES[shape_name].global_batch
    shard_t = b == 1 and cfg.attn_type != "swa"
    pattern = transformer.layer_pattern(cfg)
    if transformer.homogeneous(cfg):
        return _stacked(_layer_cache_spec(cfg, pattern[0], b, dp, shard_t))
    specs = [_layer_cache_spec(cfg, k, b, dp, shard_t) for k in pattern]
    for _ in transformer._shared_attn_points(cfg):
        specs.append(_layer_cache_spec(cfg, "shared_attn", b, dp, shard_t))
    return specs


def _input_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """The inputs of ``shape_name`` as ``{name: (shape, torch dtype)}``,
    the JAX package's ``input_specs`` without its sharding."""
    sp = SHAPES[shape_name]
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
    init_caches: Callable     # (batch, max_len, device=None)
    input_specs: Callable     # (shape_name) -> {name: (shape, dtype)}
    param_specs: Callable     # () -> {name: spec}
    batch_specs: Callable     # (shape_name, dp) -> {name: spec}
    cache_specs: Callable     # (shape_name, dp) -> caches' layout of specs


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "audio":
        return _build_encdec(cfg)
    return _build_lm(cfg)


def _build_lm(cfg: ModelConfig) -> Model:
    def init(generator: Optional[torch.Generator] = None, device=None,
             dtype: Optional[torch.dtype] = None):
        return _init(transformer.DecoderLM, cfg, generator, device, dtype)

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
        return logits, caches

    @torch.inference_mode()
    def decode_step(params, caches, batch: Dict, ranks=None,
                    dp_axes=("data",)):
        logits, caches, _ = transformer.lm_forward(
            params, cfg, batch["tokens"], q_pos=batch["pos"], caches=caches,
            ranks=ranks, dp_axes=dp_axes)
        return logits, caches

    def init_caches(batch: int, max_len: int, device=None):
        return transformer.init_caches(cfg, batch, max_len, _device(device))

    return Model(cfg, init, train_loss, prefill, decode_step, init_caches,
                 lambda shape_name: _input_specs(cfg, shape_name),
                 lambda: _param_specs(cfg),
                 lambda shape_name, dp=("pod", "data"): _batch_specs(
                     cfg, shape_name, dp),
                 lambda shape_name, dp=("pod", "data"): _lm_cache_specs(
                     cfg, shape_name, dp))


def _build_encdec(cfg: ModelConfig) -> Model:
    def init(generator: Optional[torch.Generator] = None, device=None,
             dtype: Optional[torch.dtype] = None):
        return _init(encdec.EncDec, cfg, generator, device, dtype)

    def train_loss(params, batch: Dict, ranks=None, dp_axes=("data",)):
        return encdec.train_loss(params, cfg, batch, ranks)

    @torch.inference_mode()
    def prefill(params, batch: Dict, caches, ranks=None, dp_axes=("data",)):
        enc_out = encdec.encode(params, cfg, batch["frames"])
        return encdec.decode_stack(params, cfg, batch["tokens"], enc_out,
                                   caches=caches)

    @torch.inference_mode()
    def decode_step(params, caches, batch: Dict, ranks=None,
                    dp_axes=("data",)):
        # the serving path carries the encoder output in the batch
        return encdec.decode_stack(params, cfg, batch["tokens"],
                                   batch["enc_out"], q_pos=batch["pos"],
                                   caches=caches)

    def init_caches(batch: int, max_len: int, device=None):
        return encdec.init_caches(cfg, batch, max_len, _device(device))

    def cache_specs(shape_name: str, dp=("pod", "data")):
        return _stacked(_layer_cache_spec(
            cfg, "dense", SHAPES[shape_name].global_batch, dp))

    return Model(cfg, init, train_loss, prefill, decode_step, init_caches,
                 lambda shape_name: _input_specs(cfg, shape_name),
                 lambda: _param_specs(cfg),
                 lambda shape_name, dp=("pod", "data"): _batch_specs(
                     cfg, shape_name, dp),
                 cache_specs)
