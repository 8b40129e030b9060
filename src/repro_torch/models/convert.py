"""The weight carrier: the JAX package's parameters into the port's model.

:func:`params_from_numpy` takes the JAX package's parameter pytree (as
``init`` returns it, each leaf turned into a numpy array, e.g. by
``jax.tree.map(np.asarray, params)``) and returns the port's model
(:class:`repro_torch.models.transformer.DecoderLM`, or
:class:`repro_torch.models.encdec.EncDec` for the ``audio`` family)
holding the same weights under the same names. The stacked blocks'
leading layer axis (``blocks``, ``enc_blocks``, ``dec_blocks``) is
unstacked into ``<name>.<i>``; the heterogeneous stacks' lists are
numbered the same way. Matrix weights are stored in bfloat16, the dtype
every product casts them to first, so the port computes with exactly the
values the JAX package uses; what the JAX package uses in float32 (the
router, the norms, ``shared_gate``, the SSM decay and skip parameters,
sLSTM's recurrent weights) stays float32.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.comm import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import DecoderLM

#: the JAX trees' block collections, stacked (one leading layer axis) or
#: listed
BLOCKS = ("blocks", "enc_blocks", "dec_blocks")


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
    blocks, ``enc_blocks.<i>.mlp.w_up`` and so on."""
    out = {}
    for name, v in _leaves({k: v for k, v in tree.items()
                            if k not in BLOCKS}):
        out[name] = np.asarray(v)
    for key in BLOCKS:
        if key not in tree:
            continue
        blocks = tree[key]
        if isinstance(blocks, (list, tuple)):
            for i, block in enumerate(blocks):
                for name, v in _leaves(block):
                    out[f"{key}.{i}.{name}"] = np.asarray(v)
        else:
            for name, v in _leaves(blocks):
                v = np.asarray(v)
                for i in range(v.shape[0]):
                    out[f"{key}.{i}.{name}"] = v[i]
    return out


@torch.no_grad()
def params_from_numpy(tree: Dict, cfg: ModelConfig, device=None):
    """The port's model with the JAX package's weights (see the module
    docstring). Every parameter of the one must be a leaf of the other,
    at the same shape."""
    flat = flatten(tree)
    model = EncDec if cfg.family == "audio" else DecoderLM
    params = model(cfg, resolve_device(device))
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
