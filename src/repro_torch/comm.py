"""Ranks: the port's counterpart of a one-axis JAX mesh plus ``shard_map``.

The JAX package runs its SPMD programs inside ``shard_map`` over a named
mesh axis, and talks between devices with ``axis_name`` collectives. The
port keeps the same program structure with a **stacked** backend: every
per-rank tensor carries a leading rank axis of size ``world``, each stage
runs once over all ranks, and every collective is a tensor op on one
device:

==========================================  =================================
JAX collective (inside ``shard_map``)       stacked form
==========================================  =================================
``all_to_all(split=0, concat=0, tiled)``    ``(R_src, D_dst, ...)`` ->
                                            ``transpose(0, 1).contiguous()``
``psum``                                    sum over the rank axis
``all_gather(tiled)``                       reshape ``(R, n, ...)`` ->
                                            ``(R * n, ...)``
``axis_index``                              ``arange(world)``
==========================================  =================================

This is what lets one H100 run the 8-device main path. A
``torch.distributed`` (NCCL) backend across several cards is later work.

Entry points run on ``cuda`` unless the caller asks for ``"cpu"``; asking
for ``cuda`` without a card raises — there is no quiet CPU fallback.
"""

from __future__ import annotations

import collections
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


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
    """``world`` SPMD ranks stacked on one device (see module docstring).

    ``collectives`` counts every collective issued, by name — the port's
    counterpart of the JAX package's jaxpr collective introspection.
    """

    def __init__(self, world: int = 8, device: DeviceLike = None):
        if world < 1:
            raise ValueError(f"world={world} must be >= 1")
        self.world = int(world)
        self.device = resolve_device(device)
        self.collectives: "collections.Counter[str]" = collections.Counter()

    def __repr__(self) -> str:
        return f"Ranks(world={self.world}, device={str(self.device)!r})"

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != self.world:
            raise ValueError(f"stacked tensor leads with {x.shape[0]} ranks, "
                             f"expected {self.world}")

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``(R_src, D_dst, ...)`` -> ``(R_dst, D_src, ...)``: row ``d`` of
        rank ``s`` lands in row ``s`` of rank ``d``."""
        self._check(x)
        if x.shape[1] != self.world:
            raise ValueError(f"all_to_all needs {self.world} destination "
                             f"tiles, got {x.shape[1]}")
        self.collectives["all_to_all"] += 1
        return x.transpose(0, 1).contiguous()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the rank axis: ``(R, ...)`` -> ``(...)`` (the replicated
        result every rank would see)."""
        self._check(x)
        self.collectives["psum"] += 1
        return x.sum(dim=0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled gather: ``(R, n, ...)`` -> ``(R * n, ...)``, the array every
        rank would hold (kept once, not replicated)."""
        self._check(x)
        self.collectives["all_gather"] += 1
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def axis_index(self) -> torch.Tensor:
        """``(R,)`` int32 rank ids."""
        return torch.arange(self.world, dtype=torch.int32, device=self.device)

    def stack(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Move ``x`` (numpy or tensor, already rank-stacked) onto the
        ranks' device."""
        t = torch.as_tensor(x)
        if dtype is not None:
            t = t.to(dtype)
        t = t.to(self.device)
        self._check(t)
        return t
