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

``init(dtype=torch.float32)`` gives the training form (every parameter
float32 with a gradient, as the JAX package's ``init``); the default is
the serving form (matrix weights in bfloat16, no gradient). A training
batch holds ``tokens`` and ``labels`` (``img_embeds`` for ``vlm``,
``frames`` for ``audio``). An LM's prefill batch holds ``tokens`` (and
``img_embeds`` for ``vlm``, put in front of the text) and returns the
next-token logits; its decode batch ``tokens`` and ``pos``. The enc-dec
prefill takes ``frames`` and ``tokens`` and returns the logits at every
position, as the JAX package's; its decode takes ``tokens``, ``pos`` and
``enc_out``.

A :class:`repro_torch.comm.Ranks` grid takes the place of the JAX
package's ``mesh`` (``dp_axes`` as there): with an expert axis of more
than one rank, each MoE layer dispatches through the Sphere bucket
shuffle over it. The JAX sharding metadata (``batch_specs``,
``cache_specs``: ``PartitionSpec`` trees) has no meaning on ranks stacked
on one device; it waits for the ``torch.distributed`` backend. Both
serving calls run under ``torch.inference_mode()``; caches are written in
place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.comm import resolve_device
from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import COMPUTE_DTYPE


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
                 lambda shape_name: _input_specs(cfg, shape_name))


def _build_encdec(cfg: ModelConfig) -> Model:
    def init(generator: Optional[torch.Generator] = None, device=None,
             dtype: Optional[torch.dtype] = None):
        return _init(encdec.EncDec, cfg, generator, device, dtype)

    def train_loss(params, batch: Dict, ranks=None, dp_axes=("data",)):
        return encdec.train_loss(params, cfg, batch)

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

    return Model(cfg, init, train_loss, prefill, decode_step, init_caches,
                 lambda shape_name: _input_specs(cfg, shape_name))
