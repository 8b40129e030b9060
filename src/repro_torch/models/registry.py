"""Arch registry: build(config) -> Model bundle.

Port of ``repro/models/registry.py``: every family of ``configs/``. The
decoder-only LMs (``dense`` with GQA/SWA/MLA, ``moe``, ``ssm``,
``hybrid``, ``vlm``) build a :class:`transformer.DecoderLM`; ``audio``
builds an :class:`encdec.EncDec`. The bundle exposes the serving
surface:

  init(generator=None, device=None)                 -> params
  prefill(params, batch, caches, ranks=None)        -> (logits, caches)
  decode_step(params, caches, batch, ranks=None)    -> (logits, caches)
  init_caches(batch, max_len, device=None)

An LM's prefill batch holds ``tokens`` (and ``img_embeds`` for ``vlm``,
put in front of the text) and returns the next-token logits; its decode
batch ``tokens`` and ``pos``. The enc-dec prefill takes ``frames`` and
``tokens`` and returns the logits at every position, as the JAX
package's; its decode takes ``tokens``, ``pos`` and ``enc_out``.

A :class:`repro_torch.comm.Ranks` grid takes the place of the JAX
package's ``mesh`` (``dp_axes`` as there): with an expert axis of more
than one rank, each MoE layer dispatches through the Sphere bucket
shuffle over it. ``train_loss`` and the JAX sharding metadata
(``input_specs``, ``batch_specs``, ``cache_specs``) wait for the trainer.
Both serving calls run under ``torch.inference_mode()``; caches are
written in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.comm import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


def _device(device) -> torch.device:
    """``meta`` (shapes only: the engine's cache layout) or a device
    :func:`resolve_device` accepts."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init: Callable            # (generator=None, device=None) -> params
    prefill: Callable         # (params, batch, caches, ranks, dp_axes)
    decode_step: Callable     # (params, caches, batch, ranks, dp_axes)
    init_caches: Callable     # (batch, max_len, device=None)


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "audio":
        return _build_encdec(cfg)
    return _build_lm(cfg)


def _build_lm(cfg: ModelConfig) -> Model:
    def init(generator: Optional[torch.Generator] = None, device=None):
        """Random weights drawn on ``device`` (default: the card) from
        ``generator`` (default: torch's global one), one tensor at a
        time."""
        return transformer.init_params(cfg, generator, resolve_device(device))

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

    return Model(cfg, init, prefill, decode_step, init_caches)


def _build_encdec(cfg: ModelConfig) -> Model:
    def init(generator: Optional[torch.Generator] = None, device=None):
        return encdec.init_params(cfg, generator, resolve_device(device))

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

    return Model(cfg, init, prefill, decode_step, init_caches)
