"""Elastic scaling: re-stack state onto fewer ranks after a lost one.

Port of ``repro/train/elastic.py`` for stacked ranks
(:class:`repro_torch.comm.Ranks`). A "lost device" is a rank dropped from
the grid, as the reference's virtual CPU devices are; the card keeps
running the survivors. Because hop and stream checkpoints are
layout-agnostic byte rows in rank-major order, restart is:

  1. :func:`shrink_mesh` picks the largest usable smaller grid;
  2. :func:`remesh` re-stacks the global rows onto it — what the
     reference's ``device_put`` with ``P(axis)`` does: every old rank's
     rows land whole on one new rank, because the new extent divides the
     old one.

:func:`shardings_for` keeps the reference's axis filter on sharding specs:
a spec restored onto a grid that lacks some of its axes (``pod`` after a
pod is lost) drops them.

A train state over process ranks restarts from its Sector checkpoint
onto another grid: :func:`grid_state_specs` gives the state's specs on
the new grid (the ZeRO-1 moments' change with ``data``) and
:func:`remesh_state` restores each process's blocks under them, the
counterpart of the reference's ``remesh(tree, mesh, specs)``.
"""

from __future__ import annotations

import math
import numbers
from typing import Any, Sequence, Union

import torch

from repro_torch.comm import Ranks, Spec
from repro_torch.core.records import tree_map


def shardings_for(axes: Sequence[str], specs: Any) -> Any:
    """``specs`` (a spec, or a dict or list tree of them) filtered to the
    grid axes ``axes``: an axis the grid lacks becomes ``None``, and a
    tuple entry keeps the axes it has (the name if one is left, ``None``
    if none is), as the
    JAX package's ``shardings_for`` fixes each ``PartitionSpec`` before
    it places it."""
    have = set(axes)

    def fix(spec: Spec) -> Spec:
        out = []
        for e in spec:
            if e is None:
                out.append(None)
            elif isinstance(e, (tuple, list)):
                kept = tuple(a for a in e if a in have)
                # one name left is the name, as PartitionSpec holds it
                out.append(kept if len(kept) > 1 else
                           kept[0] if kept else None)
            else:
                out.append(e if e in have else None)
        return tuple(out)

    from repro_torch.models.convert import Stacked

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, Stacked):        # a stacked leaf's layers' specs
            return Stacked(fix(s) for s in node)
        return fix(node)
    return walk(specs)


def grid_state_specs(model, ranks, master: bool = False) -> Any:
    """The train state's specs on ``ranks``' grid, in
    :func:`repro_torch.train.trainer.state_tree`'s layout: the model's
    parameter specs filtered to the grid's axes by :func:`shardings_for`,
    and the ZeRO-1 moments (and master copy) of the grid's own
    :func:`repro_torch.train.trainer.make_state_shardings`, which change
    with the ``data`` extent."""
    from repro_torch.train.trainer import make_state_shardings, state_specs
    sizes = dict(zip(ranks.axes, ranks.shape))
    p_specs = shardings_for(ranks.axes, model.param_specs())
    return state_specs(model, *make_state_shardings(model, sizes, p_specs,
                                                    master=master))


def remesh_state(ckpt, tree_like, ranks, specs, step=None):
    """The JAX package's ``remesh(tree, mesh, specs)`` for a train state
    saved in Sector: the checkpoint ``step`` (default the last) restored
    onto ``ranks``' grid, each process getting its blocks under ``specs``
    filtered to the grid's axes, on ``ranks.device`` (a Sector checkpoint
    is the state's bytes, whatever grid saved it). Returns (tree, step)."""
    return ckpt.restore(tree_like, step, ranks=ranks,
                        specs=shardings_for(ranks.axes, specs))


def remesh(tree: Any, ranks: Ranks) -> Any:
    """Re-stack every leaf of global rank-major rows ``(N, ...)`` onto
    ``ranks``: ``(N, ...) -> (world, N / world, ...)`` on its device (a
    process's own row under :class:`repro_torch.comm.ProcessRanks`)."""
    world = ranks.world

    def restack(a):
        t = torch.as_tensor(a)
        n = t.shape[0]
        if n % world:
            raise ValueError(f"{n} rows do not split over {world} ranks")
        return ranks.stack(t.reshape((world, n // world)
                                     + tuple(t.shape[1:])))

    return tree_map(restack, tree)


def shrink_mesh(ranks: Ranks, axes: Sequence[str],
                lost_device: Union[int, Sequence[int]],
                num_buckets: int) -> Ranks:
    """Re-form the largest usable grid after losing rank(s) mid-pipeline.

    ``lost_device`` is the global (row-major over ``axes``) index of the
    dead rank — or a sequence of them. The shuffle axes shrink to the
    largest extent that still

    - divides ``num_buckets`` (bucket ownership stays contiguous),
    - divides the old extent (every old rank's rows land *whole* on one
      new rank when a checkpoint is re-stacked, so reduce groups and
      bucket segments are never split), and
    - fits on the surviving ranks.

    A flat grid shrinks its single axis; a two-level ``(dc, node)`` grid
    keeps its DCs and shrinks ``node``. Raises if no smaller extent
    qualifies (e.g. a single-rank axis). The new grid is on the same
    device."""
    axes = tuple(axes)
    if tuple(ranks.axes) != axes:
        raise ValueError(f"mesh has axes {dict(zip(ranks.axes, ranks.shape))} "
                         f"beyond the shuffle axes {axes}; cannot shrink")
    shape = tuple(ranks.shape)
    total = math.prod(shape)
    if isinstance(lost_device, numbers.Integral):
        lost = {int(lost_device)}
    else:
        lost = {int(d) for d in lost_device}
    if not lost:
        raise ValueError("shrink_mesh needs at least one lost device")
    for d in lost:
        if not 0 <= d < total:
            raise ValueError(f"lost_device={d} out of range {total}")
    survivors = total - len(lost)
    if len(axes) == 1:
        old = shape[0]
        k = next((k for k in range(old - 1, 0, -1)
                  if old % k == 0 and num_buckets % k == 0
                  and k <= survivors), None)
        new_shape = (k,) if k else ()
    else:
        dcs, nodes = shape
        k = next((k for k in range(nodes - 1, 0, -1)
                  if nodes % k == 0 and num_buckets % (dcs * k) == 0
                  and dcs * k <= survivors), None)
        new_shape = (dcs, k) if k else ()
    if not k:
        raise ValueError(
            f"cannot shrink mesh {shape} below the lost device while keeping "
            f"an extent dividing num_buckets={num_buckets}")
    return Ranks(shape=new_shape, axes=axes, device=ranks.device)
