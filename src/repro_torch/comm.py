"""Ranks: the port's counterpart of a JAX mesh plus ``shard_map``.

The JAX package runs its SPMD programs inside ``shard_map`` over named
mesh axes, and talks between devices with ``axis_name`` collectives. The
port keeps the same program structure with a **stacked** backend: every
per-rank tensor carries a leading rank axis of size ``world``, each stage
runs once over all ranks, and every collective is a tensor op on one
device.

The ranks form a grid of named axes, like a mesh: ``Ranks(8)`` is one axis
(``"data"``, the JAX package's default); ``Ranks(shape=(2, 4), axes=("dc",
"node"))`` is the wide-area grid. Ranks are flattened row-major, the order
of ``P(("dc", "node"))``, so rank ``(g, i)`` is stacked row ``g * 4 + i``.

==========================================  =================================
JAX collective (inside ``shard_map``)       stacked form
==========================================  =================================
``all_to_all(split=0, concat=0, tiled)``    view ``(*shape, D, ...)``, swap
                                            the exchanged axis with ``D``
``psum``                                    sum over the ranks of the axes
``all_gather(tiled)``                       reshape ``(R, n, ...)`` ->
                                            ``(R * n, ...)``
``axis_index``                              the rank's coordinate(s)
==========================================  =================================

This is what lets one H100 run the 8-device paths. A ``torch.distributed``
(NCCL) backend across several cards is later work.

Entry points run on ``cuda`` unless the caller asks for ``"cpu"``; asking
for ``cuda`` without a card raises — there is no quiet CPU fallback.
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]
#: an axis name, a tuple of names, or None for every axis.
AxisLike = Union[str, Sequence[str], None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            f"pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


class Ranks:
    """``world`` SPMD ranks on a named grid, stacked on one device (see the
    module docstring).

    ``Ranks(world)`` is one axis named ``"data"``; ``Ranks(shape=...,
    axes=...)`` names every axis. ``collectives`` counts every collective
    issued, by name — one per call, whatever the axes — which is what
    :func:`repro_torch.core.introspect.collective_counts` reads.
    """

    def __init__(self, world: Optional[int] = None, device: DeviceLike = None,
                 *, shape: Optional[Sequence[int]] = None,
                 axes: Optional[Sequence[str]] = None):
        if shape is None:
            shape = (8 if world is None else world,)
        shape = tuple(int(s) for s in shape)
        if axes is None:
            if len(shape) != 1:
                raise ValueError(f"a grid of shape {shape} needs axis names")
            axes = ("data",)
        axes = tuple(axes)
        if len(axes) != len(shape) or len(set(axes)) != len(axes):
            raise ValueError(f"axes={axes} do not name the {len(shape)} axes "
                             f"of shape {shape} once each")
        if any(s < 1 for s in shape):
            raise ValueError(f"shape={shape}: every axis needs >= 1 rank")
        if world is not None and world != math.prod(shape):
            raise ValueError(f"world={world} != prod(shape={shape})")
        self.shape: Tuple[int, ...] = shape
        self.axes: Tuple[str, ...] = axes
        self.world = math.prod(shape)
        self.device = resolve_device(device)
        self.collectives: "collections.Counter[str]" = collections.Counter()

    def __repr__(self) -> str:
        if len(self.axes) == 1 and self.axes[0] == "data":
            return f"Ranks(world={self.world}, device={str(self.device)!r})"
        return (f"Ranks(shape={self.shape}, axes={self.axes}, "
                f"device={str(self.device)!r})")

    # -- axes -------------------------------------------------------------------
    def axis_names(self, axis: AxisLike = None) -> Tuple[str, ...]:
        """``axis`` as a tuple of this grid's axis names (None: all)."""
        if axis is None:
            return self.axes
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.axes:
                raise ValueError(f"unknown axis {a!r}: ranks have {self.axes}")
        return names

    def axis_size(self, axis: AxisLike = None) -> int:
        """Ranks along ``axis`` (a name, a tuple of names, or None for the
        whole grid)."""
        return math.prod(self.shape[self.axes.index(a)]
                         for a in self.axis_names(axis))

    def axis_index(self, axis: AxisLike = None) -> torch.Tensor:
        """``(R,)`` int32: each rank's index along ``axis``; over several
        axes, the row-major index over them (None: the flat rank id)."""
        idx = torch.zeros(self.shape, dtype=torch.int32, device=self.device)
        for a in self.axis_names(axis):
            k = self.axes.index(a)
            view = [1] * len(self.shape)
            view[k] = self.shape[k]
            pos = torch.arange(self.shape[k], dtype=torch.int32,
                               device=self.device).reshape(view)
            idx = idx * self.shape[k] + pos
        return idx.reshape(-1)

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != self.world:
            raise ValueError(f"stacked tensor leads with {x.shape[0]} ranks, "
                             f"expected {self.world}")

    # -- collectives ------------------------------------------------------------
    def all_to_all(self, x: torch.Tensor, axis: Optional[str] = None
                   ) -> torch.Tensor:
        """Tiled ``all_to_all`` along one axis (None: over every rank as one
        flat axis). ``x`` is ``(R, D, ...)`` with ``D`` the axis size: tile
        ``j`` of a rank lands in row ``i`` of the rank that sits at ``j``
        along the axis, where ``i`` is the sender's index along it. On the
        ``(dc, node)`` grid, tile ``j`` of rank ``(g, i)`` goes to row ``i``
        of ``(g, j)`` along ``node``, and tile ``h`` to row ``g`` of ``(h,
        i)`` along ``dc``."""
        self._check(x)
        size = self.world if axis is None else self.axis_size(axis)
        if x.shape[1] != size:
            raise ValueError(f"all_to_all along {axis or self.axes} needs "
                             f"{size} destination tiles, got {x.shape[1]}")
        self.collectives["all_to_all"] += 1
        if axis is None:
            return x.transpose(0, 1).contiguous()
        k = self.axes.index(axis)
        nd = len(self.shape)
        grid = x.reshape(self.shape + tuple(x.shape[1:]))
        return grid.transpose(k, nd).contiguous().reshape(x.shape)

    def psum(self, x: torch.Tensor, axis: AxisLike = None) -> torch.Tensor:
        """Sum over the ranks of ``axis`` (None: every axis). Over every
        axis the result is the one replicated value, ``(R, ...)`` ->
        ``(...)``; over some of them it stays stacked ``(R, ...)``, each rank
        holding its group's sum."""
        self._check(x)
        self.collectives["psum"] += 1
        names = self.axis_names(axis)
        if set(names) == set(self.axes):
            return x.sum(dim=0)
        dims = tuple(self.axes.index(a) for a in names)
        grid = x.reshape(self.shape + tuple(x.shape[1:]))
        total = grid.sum(dim=dims, keepdim=True)
        return total.expand_as(grid).reshape(x.shape).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled gather over every rank: ``(R, n, ...)`` -> ``(R * n,
        ...)``, the array every rank would hold (kept once, not
        replicated)."""
        self._check(x)
        self.collectives["all_gather"] += 1
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def stack(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Move ``x`` (numpy or tensor, already rank-stacked) onto the
        ranks' device."""
        t = torch.as_tensor(x)
        if dtype is not None:
            t = t.to(dtype)
        t = t.to(self.device)
        self._check(t)
        return t
