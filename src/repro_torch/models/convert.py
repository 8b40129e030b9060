"""The weight carrier: the JAX package's parameters into the port's model.

:func:`params_from_numpy` takes the JAX package's parameter pytree (as
``init`` returns it, each leaf turned into a numpy array, e.g. by
``jax.tree.map(np.asarray, params)``) and returns the port's
:class:`repro_torch.models.transformer.DecoderLM` holding the same
weights under the same names. The homogeneous stacks' leading layer axis
is unstacked into ``blocks.<i>``. Matrix weights are stored in bfloat16,
the dtype every product casts them to first, so the port computes with
exactly the values the JAX package uses; the router, the norms and
``shared_gate`` stay float32.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.comm import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DecoderLM


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, name + ".")
        else:
            yield name, v


def flatten(tree: Dict) -> Dict[str, np.ndarray]:
    """The JAX package's pytree as ``{port parameter name: array}``:
    ``blocks.<i>.attn.wq`` for layer ``i`` of the stacked (or listed)
    blocks."""
    out = {}
    for name, v in _leaves({k: v for k, v in tree.items() if k != "blocks"}):
        out[name] = np.asarray(v)
    blocks = tree["blocks"]
    if isinstance(blocks, (list, tuple)):
        for i, block in enumerate(blocks):
            for name, v in _leaves(block):
                out[f"blocks.{i}.{name}"] = np.asarray(v)
    else:
        for name, v in _leaves(blocks):
            v = np.asarray(v)
            for i in range(v.shape[0]):
                out[f"blocks.{i}.{name}"] = v[i]
    return out


@torch.no_grad()
def params_from_numpy(tree: Dict, cfg: ModelConfig,
                      device=None) -> DecoderLM:
    """The port's model with the JAX package's weights (see the module
    docstring). Every parameter of the one must be a leaf of the other,
    at the same shape."""
    flat = flatten(tree)
    params = DecoderLM(cfg, resolve_device(device))
    own = dict(params.named_parameters())
    if set(own) != set(flat):
        raise ValueError(f"parameter names differ: only in the port "
                         f"{sorted(set(own) - set(flat))}, only in the tree "
                         f"{sorted(set(flat) - set(own))}")
    for name, p in own.items():
        v = flat[name]
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {v.shape} != {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.ascontiguousarray(v, np.float32)))
    return params
