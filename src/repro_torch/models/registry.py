"""Arch registry: build(config) -> Model bundle.

Port of ``repro/models/registry.py`` for the decoder-only ``dense`` and
``moe`` families with GQA/SWA attention. The bundle exposes the serving
surface:

  init(generator=None, device=None)                 -> params (DecoderLM)
  prefill(params, batch, caches, ranks=None)        -> (logits, caches)
  decode_step(params, caches, batch, ranks=None)    -> (logits, caches)
  init_caches(batch, max_len, device=None)

A :class:`repro_torch.comm.Ranks` grid takes the place of the JAX
package's ``mesh`` (``dp_axes`` as there): with an expert axis of more
than one rank, each MoE layer dispatches through the Sphere bucket
shuffle over it. ``train_loss`` and the JAX sharding metadata
(``input_specs``, ``batch_specs``, ``cache_specs``) wait for the trainer.
Families not ported yet raise ``NotImplementedError`` naming their
``ROADMAP.md`` item. Both serving calls run under
``torch.inference_mode()``; caches are written in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.comm import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

#: the families and attention kinds still to port, with their ROADMAP item
NOT_PORTED = {
    "mla": "ROADMAP.md queue 1, item 3 (MLA attention)",
    "ssm": "ROADMAP.md queue 1, item 4 (ssm.py)",
    "hybrid": "ROADMAP.md queue 1, item 4 (ssm.py)",
    "audio": "ROADMAP.md queue 1, item 5 (encdec.py and enc-dec serving)",
    "vlm": "ROADMAP.md queue 1, item 6 (the VLM image path)",
}


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
    for what in (cfg.family, cfg.attn_type):
        if what in NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.arch_id}: {what} is not ported yet "
                f"({NOT_PORTED[what]})")
    return _build_lm(cfg)


def _build_lm(cfg: ModelConfig) -> Model:
    def init(generator: Optional[torch.Generator] = None, device=None):
        """Random weights drawn on ``device`` (default: the card) from
        ``generator`` (default: torch's global one), one tensor at a
        time."""
        return transformer.init_params(cfg, generator, resolve_device(device))

    @torch.inference_mode()
    def prefill(params, batch: Dict, caches, ranks=None, dp_axes=("data",)):
        # only the next-token logits are materialised
        logits, caches, _ = transformer.lm_forward(
            params, cfg, batch["tokens"], q_pos=None, caches=caches,
            ranks=ranks, dp_axes=dp_axes, last_only=True)
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
