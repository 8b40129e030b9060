"""Trainer: the train step (gradient accumulation, AdamW, metrics) for any
registry model, on one device or a stacked rank grid.

Port of ``repro/train/trainer.py``. The JAX package jits the step and
donates its buffers; here the step runs eagerly and updates parameters
and moments in place under ``torch.no_grad()``. Gradients come from
``torch.autograd.grad`` over the model's parameters in the JAX package's
leaf order; a parameter the loss does not reach gets ``None``, which the
optimizer takes as a zero gradient (as JAX differentiates it).
:func:`make_state_shardings` gives the state's sharding specs as data;
``jit_train_step``'s sharded step waits for training over process ranks.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.comm import Ranks, Spec
from repro_torch.models.convert import flatten, named_leaves, unflatten
from repro_torch.models.registry import Model, meta_params
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         zero1_specs,
                                         init_opt_state)


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
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``, updating both in place.

    With ``accum_steps > 1`` the batch's leading axis must be divisible;
    the gradients of the micro batches are accumulated in float32 as
    ``acc + grad / accum_steps``; the loss returned is the last micro
    batch's and ``metrics`` holds only the optimizer's and the loss, as
    in the JAX package."""

    def train_step(params, opt_state, batch):
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
        _, _, opt_metrics = adamw_update(
            opt_cfg, named_leaves(params, model.cfg), grads, opt_state)
        return params, opt_state, dict(metrics, **opt_metrics, loss=loss)

    return train_step


def init_train_state(model: Model, generator: Optional[torch.Generator] = None,
                     device=None, master: bool = False) -> Tuple[Any, Dict]:
    """The training form of the model's parameters (float32, drawn on
    ``device`` from ``generator``) and AdamW's zero state."""
    params = model.init(generator, device, dtype=torch.float32)
    return params, init_opt_state(named_leaves(params, model.cfg), master)


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
    into ``params`` and ``opt_state``, in place."""
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
