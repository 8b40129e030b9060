"""The weight carrier: the JAX package's parameters into the port's model,
and the port's state back into the JAX package's tree layout.

:func:`params_from_numpy` takes the JAX package's parameter pytree (as
``init`` returns it, each leaf turned into a numpy array, e.g. by
``jax.tree.map(np.asarray, params)``) and returns the port's model
(:class:`repro_torch.models.transformer.DecoderLM`, or
:class:`repro_torch.models.encdec.EncDec` for the ``audio`` family)
holding the same weights under the same names. The stacked blocks'
leading layer axis (``blocks``, ``enc_blocks``, ``dec_blocks``) is
unstacked into ``<name>.<i>``; the heterogeneous stacks' lists are
numbered the same way. For serving, matrix weights are stored in
bfloat16, the dtype every product casts them to first, so the port
computes with exactly the values the JAX package uses; what the JAX
package uses in float32 (the router, the norms, ``shared_gate``, the SSM
decay and skip parameters, sLSTM's recurrent weights) stays float32.
``dtype=torch.float32`` gives the training form, every weight float32 as
the JAX package holds it. :func:`opt_state_from_numpy` carries AdamW's
state the same way.

:func:`unflatten` is :func:`flatten`'s inverse: a ``{port name: tensor}``
mapping laid out as the JAX package's tree, the layers of a stacked
collection held as one :class:`Stacked` leaf. :func:`spec_tree` lays the
port's per-layer sharding specs out the same way, a stacked leaf's spec
led by ``None`` for its layer axis, as the JAX package's ``init``
returns them. :func:`flatten`,
:func:`jax_order` and :func:`named_leaves` list leaves in the JAX
package's tree order (``jax.tree.leaves``: dict keys sorted, lists in
order), a stacked leaf's layers one after another.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.layers import Params
from repro_torch.models.transformer import DecoderLM, homogeneous

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


class Stacked(tuple):
    """One leaf of the JAX package's tree held as its layers: the leaf is
    ``torch.stack(self)``, which is never built (a checkpoint writes the
    layers one after another, the bytes of the stacked array)."""


def stacked_collections(cfg: ModelConfig) -> Tuple[str, ...]:
    """The block collections the JAX package stacks (one leading layer
    axis): both of the enc-dec, a homogeneous LM's ``blocks``."""
    if cfg.family == "audio":
        return ("enc_blocks", "dec_blocks")
    return ("blocks",) if homogeneous(cfg) else ()


def _layers(leaf) -> List:
    if isinstance(leaf, Stacked):
        return list(leaf)
    if isinstance(leaf, torch.Tensor):
        return list(leaf.unbind(0))
    leaf = np.asarray(leaf)
    return [leaf[i] for i in range(leaf.shape[0])]


def _array(leaf):
    return leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def flatten(tree: Dict) -> Dict[str, Any]:
    """The JAX package's pytree as ``{port parameter name: array}``, in
    its tree order: ``blocks.<i>.attn.wq`` for layer ``i`` of the stacked
    (or listed) blocks, ``enc_blocks.<i>.mlp.w_up`` and so on. Leaves
    stay torch tensors if they are; anything else becomes numpy. A
    stacked leaf may be an array or a :class:`Stacked`."""
    out = {}
    for key in sorted(tree):
        v = tree[key]
        if key in BLOCKS and isinstance(v, list):
            for i, block in enumerate(v):
                for name, leaf in _leaves(block):
                    out[f"{key}.{i}.{name}"] = _array(leaf)
        elif key in BLOCKS:
            for name, leaf in _leaves(v):
                for i, layer in enumerate(_layers(leaf)):
                    out[f"{key}.{i}.{name}"] = _array(layer)
        elif isinstance(v, dict):
            for name, leaf in _leaves(v, key + "."):
                out[name] = _array(leaf)
        else:
            out[key] = _array(v)
    return out


def _set(tree: Dict, path: List[str], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def unflatten(flat: Mapping[str, Any], cfg: ModelConfig) -> Dict:
    """``{port name: tensor}`` laid out as the JAX package's tree: dicts
    by name, a heterogeneous stack's blocks as a list, the layers of a
    stacked collection (:func:`stacked_collections`) as one
    :class:`Stacked` leaf each. No tensor is copied."""
    stacked = stacked_collections(cfg)
    tree: Dict = {}
    layers: Dict[Tuple[str, ...], Dict[int, Any]] = {}
    for name, v in flat.items():
        parts = name.split(".")
        if parts[0] not in BLOCKS:
            _set(tree, parts, v)
            continue
        i = int(parts[1])
        if parts[0] in stacked:
            layers.setdefault((parts[0],) + tuple(parts[2:]), {})[i] = v
            continue
        blocks = tree.setdefault(parts[0], [])
        blocks.extend({} for _ in range(i + 1 - len(blocks)))
        _set(blocks[i], parts[2:], v)
    for path, by_layer in layers.items():
        _set(tree, list(path), Stacked(by_layer[i]
                                       for i in range(len(by_layer))))
    return tree


def spec_tree(specs: Mapping[str, Tuple], cfg: ModelConfig) -> Dict:
    """``{port name: spec}`` (:func:`repro_torch.models.layers.param_specs`)
    laid out as the JAX package's spec tree: the spec of a stacked leaf is
    its layers' one spec, led by ``None``."""
    def fix(node):
        if isinstance(node, list):
            return [fix(v) for v in node]
        if isinstance(node, Stacked):
            if len(set(node)) != 1:
                raise ValueError(f"the layers of a stacked leaf have specs "
                                 f"{sorted(set(node), key=str)}")
            return (None,) + node[0]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node
    return fix(unflatten(specs, cfg))


def jax_order(names, cfg: ModelConfig) -> List[str]:
    """Port parameter names sorted into the JAX package's leaf order."""
    stacked = stacked_collections(cfg)

    def key(name: str):
        parts = name.split(".")
        if parts[0] in stacked:       # the leaf <collection>.<rest>, layer i
            return tuple(parts[:1] + parts[2:]) + (int(parts[1]),)
        return tuple(int(p) if p.isdigit() else p for p in parts)
    return sorted(names, key=key)


def named_leaves(params: Params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, in the JAX package's leaf order."""
    own = dict(params.named_parameters())
    return {name: own[name] for name in jax_order(own, cfg)}


@torch.no_grad()
def params_from_numpy(tree: Dict, cfg: ModelConfig, device=None,
                      dtype: Optional[torch.dtype] = None):
    """The port's model with the JAX package's weights (see the module
    docstring); ``dtype=torch.float32`` for the training form. Every
    parameter of the one must be a leaf of the other, at the same
    shape."""
    flat = flatten(tree)
    model = EncDec if cfg.family == "audio" else DecoderLM
    params = model(cfg, resolve_device(device))
    if dtype is not None:
        if dtype != torch.float32:
            raise ValueError(f"the training form is float32, not {dtype}")
        params.trainable()
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


def opt_state_from_numpy(tree: Dict, cfg: ModelConfig, device=None) -> Dict:
    """The JAX package's AdamW state (``m``, ``v``, ``step`` and the
    optional ``master``, each leaf a numpy array) as the port's: every
    moment float32 by port name in the JAX package's leaf order, ``step``
    an int32 scalar."""
    dev = resolve_device(device)

    def moments(t):
        flat = flatten(t)
        return {name: torch.from_numpy(np.ascontiguousarray(
            flat[name], np.float32)).to(dev)
            for name in jax_order(flat, cfg)}
    out = {"m": moments(tree["m"]), "v": moments(tree["v"]),
           "step": torch.tensor(int(np.asarray(tree["step"])),
                                dtype=torch.int32, device=dev)}
    if "master" in tree:
        out["master"] = moments(tree["master"])
    return out
