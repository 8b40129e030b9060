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
``pmax``                                    max over the ranks of the axes
``psum_scatter(tiled)``                     ``reduce_scatter``: the sum,
                                            each rank keeping its block
``all_gather(tiled)``                       reshape ``(R, n, ...)`` ->
                                            ``(R * n, ...)``; along some
                                            axes, each group's tiles
``axis_index``                              the rank's coordinate(s)
==========================================  =================================

This is what lets one H100 run the 8-device paths.

:class:`ProcessRanks` is the ``torch.distributed`` backend: one rank per
process, the same API with a leading axis of 1 (``rows``: the rows a
process holds, ``world`` for :class:`Ranks`, 1 here). Each collective
runs over a process group of the axes it names: ``all_to_all_single``,
``all_reduce`` (sum and max), ``reduce_scatter_tensor`` and
``all_gather_into_tensor``. :func:`spawn_ranks` starts
the processes (``spawn``), :meth:`ProcessRanks.from_env` joins a
``torchrun`` launch. Its transport is the one the caller names: ``gloo``
(the CPU, or CUDA tensors staged through host memory inside gloo, several
ranks on one card) or ``nccl`` (one card a rank; fewer cards than ranks
raises).

:func:`shard_slices` cuts the block of a global array that a rank holds
under a sharding spec (a tuple with one entry per dimension: ``None``, an
axis name or a tuple of names, the entries of a JAX ``PartitionSpec``).

Tensor parallelism over process ranks: :func:`model_parallel` is the one
test every layer makes before it takes a sharded path (a process, one
row, on a grid whose ``model`` axis has more than one rank; the stacked
backend never), and :func:`copy_to`, :func:`reduce_from` and
:func:`gather_from` are the differentiable collectives the layers use,
with :func:`exchange` (an ``all_to_all`` each way), :func:`scatter_sum`
(a ``reduce_scatter``, its backward an ``all_gather``) and
:func:`sum_both` (a ``psum`` each way), counted and logged like the
others.

Entry points run on ``cuda`` unless the caller asks for ``"cpu"``; asking
for ``cuda`` without a card raises — there is no quiet CPU fallback.
"""

from __future__ import annotations

import collections
import datetime
import itertools
import math
import os
import shutil
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import is_fake

DeviceLike = Union[str, torch.device, None]
#: an axis name, a tuple of names, or None for every axis.
AxisLike = Union[str, Sequence[str], None]
#: a sharding spec: one entry per dimension, each None (replicated), an
#: axis name or a tuple of names (the entries of a ``PartitionSpec``)
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


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
        #: rows of the leading rank axis this object holds
        self.rows = self.world
        self.device = resolve_device(device)
        self.collectives: "collections.Counter[str]" = collections.Counter()

    def __repr__(self) -> str:
        if len(self.axes) == 1 and self.axes[0] == "data":
            return f"Ranks(world={self.world}, device={str(self.device)!r})"
        return (f"Ranks(shape={self.shape}, axes={self.axes}, "
                f"device={str(self.device)!r})")

    # -- axes -----------------------------------------------------------------
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
        if x.shape[0] != self.rows:
            raise ValueError(f"stacked tensor leads with {x.shape[0]} ranks, "
                             f"expected {self.rows}")

    # -- collectives ----------------------------------------------------------
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

    def pmax(self, x: torch.Tensor, axis: AxisLike = None) -> torch.Tensor:
        """The largest value over the ranks of ``axis``, laid out as
        :meth:`psum` lays out its sum."""
        self._check(x)
        self.collectives["pmax"] += 1
        names = self.axis_names(axis)
        if set(names) == set(self.axes):
            return x.amax(dim=0)
        dims = tuple(self.axes.index(a) for a in names)
        grid = x.reshape(self.shape + tuple(x.shape[1:]))
        top = grid.amax(dim=dims, keepdim=True)
        return top.expand_as(grid).reshape(x.shape).contiguous()

    def _group_rows(self, x: torch.Tensor, names: Tuple[str, ...]
                    ) -> torch.Tensor:
        """``(R, ...)`` -> ``(R, size, ...)``: each rank's group's rows
        along ``names`` (the ranks that share its coordinates on every
        other axis), in the group's order, row-major over ``names``."""
        k = [self.axes.index(a) for a in names]
        members = []
        for r in range(self.world):
            c = list(grid_coords(self.shape, r))
            row = []
            for idx in itertools.product(*(range(self.shape[i]) for i in k)):
                for i, v in zip(k, idx):
                    c[i] = v
                row.append(_flat_rank(self.shape, c))
            members.append(row)
        return x[torch.tensor(members, device=x.device)]

    def reduce_scatter(self, x: torch.Tensor, axis: AxisLike
                       ) -> torch.Tensor:
        """The sum over the ranks of ``axis``, cut along dimension 1 into
        as many blocks as the axis has ranks: ``(R, n, ...)`` -> ``(R, n /
        size, ...)``, each rank holding the block of its index along the
        axis (:meth:`axis_index`)."""
        self._check(x)
        names = self.axis_names(axis)
        size = self.axis_size(names)
        if x.shape[1] % size:
            raise ValueError(f"reduce_scatter over {names}: {x.shape[1]} "
                             f"rows do not split into {size} blocks")
        self.collectives["reduce_scatter"] += 1
        total = self._group_rows(x, names).sum(dim=1)
        n = x.shape[1] // size
        idx = self.axis_index(names).long()
        blocks = total.reshape((self.world, size, n) + tuple(x.shape[2:]))
        return blocks[torch.arange(self.world, device=x.device), idx]

    def all_gather(self, x: torch.Tensor, axis: AxisLike = None
                   ) -> torch.Tensor:
        """Tiled gather: over every rank (``axis`` None), ``(R, n, ...)``
        -> ``(R * n, ...)``, the array every rank would hold (kept once,
        not replicated); over some axes, ``(R, n, ...)`` -> ``(R, size *
        n, ...)``, each rank holding its group's tiles in group order."""
        self._check(x)
        self.collectives["all_gather"] += 1
        names = self.axis_names(axis)
        if set(names) == set(self.axes):
            return x.reshape((-1,) + tuple(x.shape[2:]))
        rows = self._group_rows(x, names)
        return rows.reshape((self.world, -1) + tuple(x.shape[2:]))

    def stack(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Move ``x`` (numpy or tensor, already rank-stacked) onto the
        ranks' device."""
        t = torch.as_tensor(x)
        if dtype is not None:
            t = t.to(dtype)
        t = t.to(self.device)
        self._check(t)
        return t


# -- sharding specs -----------------------------------------------------------


def _spec_names(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def grid_coords(shape: Sequence[int], rank: int) -> Tuple[int, ...]:
    """Flat ``rank``'s coordinate on a grid of ``shape`` (row-major)."""
    coords = []
    for size in reversed(tuple(shape)):
        coords.append(rank % size)
        rank //= size
    return tuple(reversed(coords))


def _flat_rank(shape: Sequence[int], coords: Sequence[int]) -> int:
    rank = 0
    for size, c in zip(shape, coords):
        rank = rank * size + c
    return rank


def shard_slices(global_shape: Sequence[int], spec: Spec,
                 shape: Sequence[int], axes: Sequence[str],
                 rank: int) -> Tuple[slice, ...]:
    """The block of a ``global_shape`` array that flat ``rank`` of the
    grid ``(shape, axes)`` holds under ``spec``, as ``NamedSharding``
    places it: a dimension whose entry names axes splits into as many
    equal blocks as those axes have ranks, and the rank takes the block of
    its row-major index over them (in the entry's order); ``None`` and
    missing trailing entries keep the whole dimension."""
    shape, axes = tuple(shape), tuple(axes)
    if len(spec) > len(global_shape):
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{len(global_shape)} dimensions")
    coords = grid_coords(shape, rank)
    out = []
    for dim, n in enumerate(global_shape):
        entry = spec[dim] if dim < len(spec) else None
        if entry is None:
            out.append(slice(None))
            continue
        parts, idx = 1, 0
        for a in _spec_names(entry):
            if a not in axes:
                raise ValueError(f"spec {spec} names axis {a!r}; the grid "
                                 f"has {axes}")
            k = axes.index(a)
            parts *= shape[k]
            idx = idx * shape[k] + coords[k]
        if n % parts:
            raise ValueError(f"dimension {dim} of {n} does not split into "
                             f"{parts} blocks (spec {spec})")
        block = n // parts
        out.append(slice(idx * block, (idx + 1) * block))
    return tuple(out)


# -- the torch.distributed backend --------------------------------------------


def _check_cards(backend: str, world: int) -> None:
    """NCCL puts one rank on each card: fewer cards than ranks raises
    (gloo is the transport that shares a card, and the caller names it)."""
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise ValueError(
            f"backend='nccl' needs one card a rank: {world} ranks, "
            f"{torch.cuda.device_count()} cards (NCCL refuses two ranks on "
            f"one card; name backend='gloo' to share one)")


#: ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` under their
#: newer names where torch has them
_all_gather_single = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    getattr(dist, "reduce_scatter_tensor", None)


#: the backends whose collectives take host tensors over any group: gloo,
#: and ``fake`` (``torch.testing``'s process group of a traced program,
#: which moves nothing)
_HOST_BACKENDS = ("gloo", "fake")


def _all_reduce_max(t: torch.Tensor, group=None) -> None:
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)


class ProcessRanks(Ranks):
    """One rank of a grid of processes: :class:`Ranks`' API over
    ``torch.distributed``, every tensor holding this process's row only
    (a leading axis of ``rows`` = 1).

    Built after ``init_process_group`` (:func:`spawn_ranks`,
    :meth:`from_env`), the same way on every rank: it creates one process
    group per coordinate of the other axes for every proper subset of the
    axes, in one order, so that every collective runs over the group of
    the axes it names (the whole grid: the default group). Ranks are
    row-major on the grid, and a group's ranks ascend along its axes.
    ``device`` defaults to ``cuda:{rank % cards}``; ``"cpu"`` asks for the
    CPU. ``collectives`` counts each call as :class:`Ranks` does.

    ``log``: set it to a list and each collective appends ``{"op", "axes",
    "bytes", "seconds"}``: the bytes this rank hands to the transport and
    the call's host time, the card synchronised before and after it (a
    measurement mode: the synchronisations cost what they cost; a traced
    program's fake tensors are neither synchronised nor timed).

    Host tensors (a checkpoint's bytes, :meth:`gather_to_first`), objects
    and barriers go over the whole grid. Under gloo that is the default
    group; beside NCCL, which takes CUDA tensors only, a gloo group of
    the whole grid made at the first such call (every process makes its
    first one at the same point: it is a collective).
    """

    def __init__(self, shape: Sequence[int], axes: Optional[Sequence[str]]
                 = None, *, backend: Optional[str] = None,
                 device: DeviceLike = None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessRanks needs an initialised process "
                               "group (spawn_ranks or ProcessRanks.from_env)")
        have = dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f"backend={backend!r}, but the process group "
                             f"runs {have!r}")
        world, rank = dist.get_world_size(), dist.get_rank()
        _check_cards(have, world)
        dev = torch.device("cuda" if device is None else device)
        if (dev.type == "cuda" and dev.index is None
                and torch.cuda.is_available()):
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        super().__init__(device=dev, shape=shape, axes=axes)
        if self.world != world:
            raise ValueError(f"a grid of {self.world} ranks in a process "
                             f"group of {world}")
        if have == "nccl" and self.device.type != "cuda":
            raise ValueError("backend='nccl' runs on CUDA tensors only")
        self.rows = 1
        self.rank = rank
        self.backend = have
        self.coords = grid_coords(self.shape, rank)
        self.log: Optional[List[Dict[str, Any]]] = None
        self._groups: Dict[Tuple[str, ...], Any] = {}
        self._host: Any = None
        for r in range(1, len(self.axes)):
            for names in itertools.combinations(self.axes, r):
                rest = [k for k, a in enumerate(self.axes) if a not in names]
                for fixed in itertools.product(
                        *(range(self.shape[k]) for k in rest)):
                    members = [q for q in range(world)
                               if all(grid_coords(self.shape, q)[k] == c
                                      for k, c in zip(rest, fixed))]
                    group = dist.new_group(members)
                    if rank in members:
                        self._groups[names] = group

    @classmethod
    def from_env(cls, shape: Optional[Sequence[int]] = None,
                 axes: Optional[Sequence[str]] = None, *,
                 backend: str = "gloo", device: DeviceLike = None,
                 timeout_s: float = 600.0) -> "ProcessRanks":
        """Join a ``torchrun`` launch: ``RANK``, ``WORLD_SIZE``,
        ``MASTER_ADDR`` and ``MASTER_PORT`` from the environment; ``shape``
        defaults to one ``"data"`` axis over the world."""
        world = int(os.environ["WORLD_SIZE"])
        _check_cards(backend, world)
        if not dist.is_initialized():
            dist.init_process_group(
                backend, init_method="env://", rank=int(os.environ["RANK"]),
                world_size=world,
                timeout=datetime.timedelta(seconds=timeout_s))
        return cls((world,) if shape is None else shape, axes,
                   backend=backend, device=device)

    def __repr__(self) -> str:
        return (f"ProcessRanks(shape={self.shape}, axes={self.axes}, "
                f"rank={self.rank}, backend={self.backend!r}, "
                f"device={str(self.device)!r})")

    def host_group(self):
        """The group of the whole grid for host tensors and objects: the
        default group (None) under gloo (or the ``fake`` backend of a
        traced program, which takes any tensor), else a gloo group of its
        own."""
        if self.backend in _HOST_BACKENDS:
            return None
        if self._host is None:
            self._host = dist.new_group(backend="gloo")
        return self._host

    def _group(self, names: Tuple[str, ...], host: bool = False):
        """The process group of ``names`` (None: the default group), for
        host tensors with ``host``."""
        key = tuple(a for a in self.axes if a in names)
        whole = len(key) == len(self.axes)
        if host and self.backend not in _HOST_BACKENDS:
            if not whole:
                raise ValueError(f"{self.backend} takes device tensors: "
                                 f"host tensors go over the whole grid, "
                                 f"not {key}")
            return self.host_group()
        return None if whole else self._groups[key]

    def _call(self, op: str, names: Tuple[str, ...], fn, *tensors) -> None:
        """``fn(*tensors, group=...)``, logged when :attr:`log` is a list
        (a traced call of fake tensors with no synchronisation or timing:
        its ``seconds`` are 0)."""
        group = self._group(names, tensors[-1].device.type == "cpu")
        if self.log is None:
            fn(*tensors, group=group)
            return
        if is_fake(tensors[-1]):
            fn(*tensors, group=group)
            self.log.append({"op": op, "axes": list(names),
                             "bytes": tensors[-1].numel()
                             * tensors[-1].element_size(), "seconds": 0.0})
            return
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        fn(*tensors, group=group)
        if cuda:
            torch.cuda.synchronize(self.device)
        self.log.append({"op": op, "axes": list(names),
                         "bytes": tensors[-1].numel()
                         * tensors[-1].element_size(),
                         "seconds": time.perf_counter() - t0})

    def axis_index(self, axis: AxisLike = None) -> torch.Tensor:
        return torch.tensor([axis_position(self, axis)], dtype=torch.int32,
                            device=self.device)

    def all_to_all(self, x: torch.Tensor, axis: Optional[str] = None
                   ) -> torch.Tensor:
        self._check(x)
        names = self.axes if axis is None else self.axis_names(axis)
        if axis is not None and len(names) != 1:
            raise ValueError(f"all_to_all runs along one axis, got {axis}")
        size = self.axis_size(names)
        if x.shape[1] != size:
            raise ValueError(f"all_to_all along {axis or self.axes} needs "
                             f"{size} destination tiles, got {x.shape[1]}")
        self.collectives["all_to_all"] += 1
        send = x[0].contiguous()
        recv = torch.empty_like(send)
        self._call("all_to_all", names, dist.all_to_all_single, recv, send)
        return recv.unsqueeze(0)

    def psum(self, x: torch.Tensor, axis: AxisLike = None) -> torch.Tensor:
        self._check(x)
        self.collectives["psum"] += 1
        names = self.axis_names(axis)
        # in the dtype of the stacked backend's sum (torch.sum widens
        # integers and bool to int64), so both give the same tensors
        total = x[0].to(torch.sum(x[:0], dim=0).dtype,
                        memory_format=torch.contiguous_format, copy=True)
        self._call("psum", names, dist.all_reduce, total)
        if set(names) == set(self.axes):
            return total
        return total.unsqueeze(0)

    def pmax(self, x: torch.Tensor, axis: AxisLike = None) -> torch.Tensor:
        self._check(x)
        self.collectives["pmax"] += 1
        names = self.axis_names(axis)
        top = x[0].clone(memory_format=torch.contiguous_format)
        self._call("pmax", names, _all_reduce_max, top)
        if set(names) == set(self.axes):
            return top
        return top.unsqueeze(0)

    def reduce_scatter(self, x: torch.Tensor, axis: AxisLike
                       ) -> torch.Tensor:
        self._check(x)
        names = self.axis_names(axis)
        size = self.axis_size(names)
        if x.shape[1] % size:
            raise ValueError(f"reduce_scatter over {names}: {x.shape[1]} "
                             f"rows do not split into {size} blocks")
        self.collectives["reduce_scatter"] += 1
        send = x[0].contiguous()
        recv = send.new_empty((send.shape[0] // size,)
                              + tuple(send.shape[1:]))
        self._call("reduce_scatter", names, _reduce_scatter_single, recv,
                   send)
        return recv.unsqueeze(0)

    def all_gather(self, x: torch.Tensor, axis: AxisLike = None
                   ) -> torch.Tensor:
        self._check(x)
        self.collectives["all_gather"] += 1
        names = self.axis_names(axis)
        size = self.axis_size(names)
        part = x[0].contiguous()
        out = part.new_empty((size * part.shape[0],)
                             + tuple(part.shape[1:]))
        self._call("all_gather", names, _all_gather_single, out, part)
        if set(names) == set(self.axes):
            return out
        return out.unsqueeze(0)

    def all_to_all_v(self, x: torch.Tensor, send: Sequence[int],
                     recv: Sequence[int], axis: AxisLike) -> torch.Tensor:
        """``all_to_all`` with blocks of given sizes: ``x`` is ``(1,
        sum(send), ...)``, its consecutive blocks of ``send[j]`` rows going
        to the rank at ``j`` along ``axis``; the result ``(1, sum(recv),
        ...)`` holds the blocks of ``recv[i]`` rows from the rank at ``i``,
        in the axis's order. ``axis`` may name several axes (None: the
        whole grid), their ranks in the grid's row-major order. Counted
        as ``all_to_all``."""
        self._check(x)
        names = tuple(a for a in self.axes if a in self.axis_names(axis))
        size = self.axis_size(names)
        if len(send) != size or len(recv) != size:
            raise ValueError(f"all_to_all_v over {size} ranks: axis "
                             f"{axis}, {len(send)} send and {len(recv)} "
                             f"receive sizes")
        if sum(send) != x.shape[1]:
            raise ValueError(f"send sizes {list(send)} do not cover "
                             f"{x.shape[1]} rows")
        self.collectives["all_to_all"] += 1
        part = x[0].contiguous()
        out = part.new_empty((sum(recv),) + tuple(part.shape[1:]))
        self._call("all_to_all", names,
                   lambda o, i, group: dist.all_to_all_single(
                       o, i, list(recv), list(send), group=group), out, part)
        return out.unsqueeze(0)

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every process's picklable ``obj`` in rank order, on every
        process: small host metadata (a checkpoint's file table, a flag),
        counted as ``all_gather_object``."""
        self.collectives["all_gather_object"] += 1
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host_group())
        return out

    def barrier(self) -> None:
        """Wait for every process of the grid; counted as ``barrier``."""
        self.collectives["barrier"] += 1
        dist.barrier(group=self.host_group())

    def gather_to_first(self, x: torch.Tensor
                        ) -> Optional[List[torch.Tensor]]:
        """Every process's ``x`` (no rank axis, one shape on all), in rank
        order, on process 0; None on the others. A check's tool (a rank
        grid's shards assembled on one process), counted and logged as
        ``gather``; the tensors travel through host memory."""
        self.collectives["gather"] += 1
        part = x.detach().cpu().contiguous()
        parts = ([torch.empty_like(part) for _ in range(self.world)]
                 if self.rank == 0 else None)
        self._call("gather", self.axes,
                   lambda t, group: dist.gather(t, parts, dst=0,
                                                group=group), part)
        return parts

    def stack(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """This rank's row of ``x``, the global rank-stacked array (a
        tensor, a numpy array or a memmap: only the row is read), on the
        rank's device."""
        if x.shape[0] != self.world:
            raise ValueError(f"stacked input leads with {x.shape[0]} ranks, "
                             f"expected {self.world}")
        row = x[self.rank:self.rank + 1]
        if not isinstance(row, torch.Tensor):
            import numpy as np
            row = torch.from_numpy(np.array(row))     # a copy: memmaps
        if dtype is not None:
            row = row.to(dtype)
        return row.to(self.device)

    def local_shard(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The block of the global ``t`` this rank holds under ``spec``
        (:func:`shard_slices`), a view."""
        return t[shard_slices(t.shape, spec, self.shape, self.axes,
                              self.rank)]


# -- tensor parallelism over process ranks -----------------------------------


def model_parallel(ranks: Optional[Ranks]) -> bool:
    """Whether a process holds shards of the weights: one row a process
    (:class:`ProcessRanks`) on a grid whose ``model`` axis has more than
    one rank. Every layer asks this before it takes a sharded path; the
    stacked :class:`Ranks` never hold shards and run as they always did."""
    return (ranks is not None and ranks.rows == 1 and ranks.world > 1
            and "model" in ranks.axes and ranks.axis_size("model") > 1)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis name a spec's entries hold, in order."""
    return tuple(a for e in spec if e is not None for a in _spec_names(e))


def axis_position(ranks: "ProcessRanks", axis: AxisLike) -> int:
    """This process's index along ``axis`` (row-major over several), as
    a Python int: :meth:`Ranks.axis_index` without the device."""
    idx = 0
    for a in ranks.axis_names(axis):
        k = ranks.axes.index(a)
        idx = idx * ranks.shape[k] + ranks.coords[k]
    return idx


def _local_psum(ranks: "ProcessRanks", x: torch.Tensor,
                axis: AxisLike) -> torch.Tensor:
    """``psum`` of a process's tensor (no rank axis) in float32, rounded
    once to ``x``'s dtype."""
    total = ranks.psum(x.float().unsqueeze(0), axis)
    return total.reshape(x.shape).to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, axis):
        ctx.ranks, ctx.axis = ranks, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _local_psum(ctx.ranks, g, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, axis):
        return _local_psum(ranks, x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, axis, dim):
        ctx.n, ctx.dim = x.shape[dim], dim
        ctx.start = axis_position(ranks, axis) * x.shape[dim]
        part = x.movedim(dim, 0).contiguous()
        full = ranks.all_gather(part.unsqueeze(0), axis)
        full = full.reshape((-1,) + tuple(part.shape[1:]))
        return full.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None, None


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, axis, dim):
        ctx.ranks, ctx.axis, ctx.dim = ranks, axis, dim
        part = x.movedim(dim, 0).contiguous()
        full = ranks.all_gather(part.unsqueeze(0), axis)
        full = full.reshape((-1,) + tuple(part.shape[1:]))
        return full.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        part = g.float().movedim(ctx.dim, 0).contiguous()
        mine = ctx.ranks.reduce_scatter(part.unsqueeze(0), ctx.axis)[0]
        return (mine.movedim(0, ctx.dim).to(g.dtype).contiguous(), None,
                None, None)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, axis, dim, send, recv):
        ctx.ranks, ctx.axis, ctx.dim = ranks, axis, dim
        ctx.send, ctx.recv = send, recv
        return _exchange(ranks, x, axis, dim, send, recv)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(ctx.ranks, g, ctx.axis, ctx.dim, ctx.recv,
                          ctx.send), None, None, None, None, None)


def _exchange(ranks, x, axis, dim, send, recv):
    part = x.movedim(dim, 0).contiguous()
    out = ranks.all_to_all_v(part.unsqueeze(0), send, recv, axis)[0]
    return out.movedim(0, dim).contiguous()


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, axis, dim):
        ctx.ranks, ctx.axis, ctx.dim = ranks, axis, dim
        part = x.float().movedim(dim, 0).contiguous()
        mine = ranks.reduce_scatter(part.unsqueeze(0), axis)[0]
        return mine.movedim(0, dim).to(x.dtype).contiguous()

    @staticmethod
    def backward(ctx, g):
        part = g.movedim(ctx.dim, 0).contiguous()
        full = ctx.ranks.all_gather(part.unsqueeze(0), ctx.axis)
        full = full.reshape((-1,) + tuple(part.shape[1:]))
        return full.movedim(0, ctx.dim).contiguous(), None, None, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, axis):
        ctx.ranks, ctx.axis = ranks, axis
        return _local_psum(ranks, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _local_psum(ctx.ranks, g, ctx.axis), None, None


def _one_row(ranks: Ranks) -> None:
    if ranks.rows != 1:
        raise ValueError(f"{ranks!r} stacks {ranks.rows} rows; the "
                         f"differentiable collectives take one process's")


def copy_to(ranks: "ProcessRanks", x: torch.Tensor,
            axis: AxisLike) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``axis``
    (one ``psum``, in float32, rounded once to the gradient's dtype).
    Where a replicated activation enters a column-parallel product: each
    rank's gradient of it is its own columns' share."""
    _one_row(ranks)
    return _CopyTo.apply(x, ranks, axis)


def reduce_from(ranks: "ProcessRanks", x: torch.Tensor,
                axis: AxisLike) -> torch.Tensor:
    """``psum`` over ``axis`` forward, in float32 and rounded once to
    ``x``'s dtype (bfloat16 partial products summed so come closest to
    the one-process product); identity backward. After a row-parallel
    product, and wherever ranks add up parts of one replicated value."""
    _one_row(ranks)
    return _ReduceFrom.apply(x, ranks, axis)


def gather_from(ranks: "ProcessRanks", x: torch.Tensor, axis: AxisLike,
                dim: int) -> torch.Tensor:
    """``all_gather`` along ``dim`` over ``axis`` forward (no arithmetic:
    the blocks in ``x``'s dtype, in the axis's order); the backward keeps
    this rank's block of the gradient. After sequence-parallel
    attention."""
    _one_row(ranks)
    return _GatherFrom.apply(x, ranks, axis, dim % x.dim())


def gather_heads(ranks: "ProcessRanks", x: torch.Tensor, axis: AxisLike,
                 dim: int) -> torch.Tensor:
    """``all_gather`` along ``dim`` over ``axis`` forward (the blocks in
    ``x``'s dtype, in the axis's order); the backward sums the
    gradient over ``axis`` and keeps this rank's block
    (``reduce_scatter``, in float32, rounded once to the gradient's
    dtype): the transpose of :func:`scatter_sum`. Where each rank holds
    a block of some heads' columns and every rank reads whole heads, each
    another one (the split-dim keys and values of ``1 < KV < model``):
    the gradient of a rank's columns is what every rank reading their
    head sends back, where :func:`gather_from` would keep only its
    own."""
    _one_row(ranks)
    return _GatherHeads.apply(x, ranks, axis, dim % x.dim())


def exchange(ranks: "ProcessRanks", x: torch.Tensor, send: Sequence[int],
             recv: Sequence[int], axis: str, dim: int) -> torch.Tensor:
    """``all_to_all`` over ``axis`` along ``dim`` forward: ``x``'s
    consecutive blocks of ``send[j]`` along ``dim`` go to the rank at
    ``j``, and the result joins the blocks of ``recv[i]`` from the rank
    at ``i`` in the axis's order (no arithmetic: the values in ``x``'s
    dtype). The backward is the inverse ``all_to_all``. Where a
    column-parallel product's blocks are not the columns a rank goes on
    with (Mamba2's and mLSTM's ``[z | x]``)."""
    _one_row(ranks)
    return _Exchange.apply(x, ranks, axis, dim % x.dim(), tuple(send),
                           tuple(recv))


def scatter_sum(ranks: "ProcessRanks", x: torch.Tensor, axis: AxisLike,
                dim: int) -> torch.Tensor:
    """The sum over ``axis`` (``reduce_scatter``, in float32, rounded once
    to ``x``'s dtype) of ``x``, keeping this rank's block of ``dim`` (as
    many equal blocks as the axis has ranks, in its order). The backward
    ``all_gather``s the blocks' gradients: each rank's ``x`` feeds every
    block. After a row-parallel product whose output columns the ranks
    then split (mLSTM's q, k, v and gates): ``reduce_from`` and a slice
    would keep only this rank's block of the gradient."""
    _one_row(ranks)
    return _ScatterSum.apply(x, ranks, axis, dim % x.dim())


def sum_both(ranks: "ProcessRanks", x: torch.Tensor,
             axis: AxisLike) -> torch.Tensor:
    """``psum`` over ``axis`` forward and backward (in float32, rounded
    once to the dtype): where every rank reads the sum and each rank's
    read differs (a norm's squares over a sharded dimension), so that
    each rank's gradient of the sum is a part of the whole one."""
    _one_row(ranks)
    return _SumBoth.apply(x, ranks, axis)


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, shape, axes, backend: str,
               device, timeout_s: float, fn: Callable, args: tuple,
               out_dir: str) -> None:
    """One spawned rank: join the group, run ``fn``, write its result (or
    the traceback) under ``out_dir``."""
    from repro_torch.kernels import build
    os.environ[build.PREBUILT_ENV] = "1"
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        ranks = ProcessRanks(shape, axes, backend=backend, device=device)
        if ranks.device.type == "cuda":
            torch.cuda.set_device(ranks.device)
        result = fn(ranks, *args)
        path = os.path.join(out_dir, f"rank{rank}.pt")
        torch.save(result, path + ".tmp", pickle_protocol=4)
        os.replace(path + ".tmp", path)
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        # no interpreter teardown: a broken process group can block it
        os._exit(1)


def spawn_ranks(fn: Callable, shape: Sequence[int],
                axes: Optional[Sequence[str]] = None, *,
                backend: str = "gloo", device: DeviceLike = None,
                timeout_s: float = 300.0, args: tuple = ()) -> List[Any]:
    """Run ``fn(ranks, *args)`` in one process per rank of the grid
    ``(shape, axes)``, each holding a :class:`ProcessRanks`, and return
    each rank's result in rank order (passed back through files; CUDA
    tensors come back on the CPU).

    ``fn`` must be picklable (a module-level function): the processes are
    started with ``spawn``, as CUDA cannot be forked. The kernels are
    built here first when the ranks run on the card; the ranks never run
    ``nvcc``. If a rank raises, or the ranks outlast ``timeout_s``, every
    rank is killed and this raises. ``device`` as for
    :class:`ProcessRanks`: the card unless ``"cpu"`` is asked for.
    """
    shape = tuple(int(s) for s in shape)
    world = math.prod(shape)
    _check_cards(backend, world)
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all(build.KERNEL_NAMES)
    ctx = torch.multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="spawn-ranks-")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, shape, axes, backend, device,
                               timeout_s, fn, tuple(args), out_dir))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                errs = []
                for r in failed:
                    path = os.path.join(out_dir, f"rank{r}.err")
                    text = (open(path).read() if os.path.exists(path)
                            else f"exit code {procs[r].exitcode}")
                    errs.append(f"rank {r}:\n{text}")
                raise RuntimeError("spawned ranks failed:\n"
                                   + "\n".join(errs))
            if all(p.exitcode == 0 for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks outlasted timeout_s="
                                   f"{timeout_s}")
            time.sleep(0.02)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
