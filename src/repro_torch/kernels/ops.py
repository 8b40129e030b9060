"""Public entry points for the kernels (port of ``repro/kernels/ops.py``).

Each function runs where its tensors lie: on a CUDA tensor the Hopper
kernel, on a CPU tensor its plain version (the wrappers in
:mod:`repro_torch.kernels.partition`, ``bucket_hist``, ``bitonic_sort``
and ``radix_sort`` decide). The segment sorts dispatch through the autotuner
(:mod:`repro_torch.kernels.autotune`): ``algo=None`` measures
bitonic vs radix vs the ``torch.sort`` oracle once per cell; ``algo``
pins one; ``REPRO_KERNEL_FORCE`` overrides both.

Every function takes the stacked-ranks layout: a leading batch of rows,
one per rank.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import autotune, bucket_hist, ref
from repro_torch.kernels.bitonic_sort import (sort_kv_segments_bitonic,
                                              sort_segments_bitonic)
from repro_torch.kernels.partition import partition_rank
from repro_torch.kernels.radix_sort import (sort_kv_segments_radix,
                                            sort_segments_radix)

__all__ = ["pad_sentinel", "resolve_sort_algo", "bucket_histogram",
           "partition_rank",
           "partition_pack", "sort_segments", "sort_kv_segments"]


def pad_sentinel(dtype: torch.dtype):
    """Greatest value of ``dtype`` — the padding key that sorts to the end
    of a segment (+inf for floats, the integer max otherwise). Stable sorts
    keep real keys equal to it ahead of suffix padding; only the unstable
    bitonic network needs the collision guard."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def resolve_sort_algo(num_segments: int, segment_len: int,
                      dtype: torch.dtype, algo: Optional[str] = None,
                      kv: bool = True, device="cuda") -> str:
    """The algorithm :func:`sort_segments` / :func:`sort_kv_segments` will
    run for this cell, decided before the sort runs (callers use it for
    stability-dependent guards). ``REPRO_KERNEL_FORCE`` beats a pinned
    ``algo``."""
    if not os.environ.get(autotune.FORCE_ENV) and algo is not None:
        if algo not in autotune.ALGOS:
            raise ValueError(f"algo={algo!r}: expected one of "
                             f"{autotune.ALGOS} (or None to autotune)")
        return algo
    return autotune.choose(num_segments, segment_len, dtype, kv=kv,
                           device=device).algo


def bucket_histogram(bucket_ids: torch.Tensor,
                     num_buckets: int) -> torch.Tensor:
    """int32 ``(num_buckets,)`` histogram of ``(n,)`` ids, or ``(rows,
    num_buckets)`` of ``(rows, n)``; ids outside range are ignored (kernel
    K4 on the card). Ids are cast to int32 first, as the JAX wrapper
    does."""
    return bucket_hist.bucket_histogram(bucket_ids.to(torch.int32),
                                        num_buckets)


def partition_pack(
    columns: Sequence[torch.Tensor],
    dest: torch.Tensor,
    num_dest: int,
    capacity: int,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(n) fused partition/pack: lay records out contiguously per
    destination in fixed-size ``(num_dest, capacity, ...)`` tiles.

    Layout contract (the JAX package's, exactly): destination d's records
    fill slots ``[0, counts[d])`` of row d in arrival order; records past
    ``capacity`` are dropped from the tail and counted; ``origin`` is -1 on
    empty slots.

    Args:
      columns: tensors sharing the leading dims of ``dest``; each is packed
        into its own tile stack (dtypes preserved).
      dest: int32 ``(n,)`` or, stacked, ``(rows, n)``. Ids outside
        ``[0, num_dest)`` are never packed.
      capacity: slots per destination.
    Returns (tiles, in_range, origin, dropped_local), with a leading
    ``rows`` axis when ``dest`` has one:
      tiles[i]:  ``(num_dest, capacity, *columns[i].shape[dest.dim():])``
      in_range:  ``(num_dest, capacity)`` bool — slot holds a real record
      origin:    ``(num_dest, capacity)`` int32 source row, -1 when empty
      dropped_local: ``()`` int32 per row — records beyond capacity.
    """
    dest = dest.to(torch.int32)
    batched = dest.dim() == 2
    d2 = dest if batched else dest.reshape(1, -1)
    rows, n = d2.shape
    dev = d2.device
    tails = [tuple(c.shape[dest.dim():]) for c in columns]

    def unbatch(t):
        return t if batched else t[0]

    if n == 0:
        tiles = [torch.zeros((rows, num_dest, capacity) + tail, dtype=c.dtype,
                             device=dev) for c, tail in zip(columns, tails)]
        return ([unbatch(t) for t in tiles],
                unbatch(torch.zeros((rows, num_dest, capacity),
                                    dtype=torch.bool, device=dev)),
                unbatch(torch.full((rows, num_dest, capacity), -1,
                                   dtype=torch.int32, device=dev)),
                unbatch(torch.zeros((rows,), dtype=torch.int32, device=dev)))
    rank, counts = partition_rank(d2, num_dest)
    ok = (d2 >= 0) & (d2 < num_dest) & (rank < capacity)
    slots = num_dest * capacity
    # one extra overflow slot per row: only it ever sees duplicate writes
    slot = torch.where(ok, d2 * capacity + rank, slots).to(torch.int64)
    slot += torch.arange(rows, device=dev, dtype=torch.int64)[:, None] * (slots + 1)
    origin = torch.full((rows * (slots + 1),), -1, dtype=torch.int32,
                        device=dev)
    origin[slot.reshape(-1)] = torch.arange(
        n, dtype=torch.int32, device=dev).repeat(rows)
    origin = origin.reshape(rows, slots + 1)[:, :slots].reshape(
        rows, num_dest, capacity)
    cap_iota = torch.arange(capacity, dtype=torch.int32, device=dev)
    in_range = cap_iota[None, None, :] < counts[:, :, None]
    gidx = (origin.clamp(0, n - 1).to(torch.int64)
            + torch.arange(rows, device=dev, dtype=torch.int64)[:, None, None] * n
            ).reshape(-1)
    tiles = []
    for col, tail in zip(columns, tails):
        flat = col.reshape((rows * n,) + tail)
        tiles.append(flat.index_select(0, gidx).reshape(
            (rows, num_dest, capacity) + tail))
    dropped = (counts - capacity).clamp(min=0).sum(dim=1, dtype=torch.int32)
    return ([unbatch(t) for t in tiles], unbatch(in_range), unbatch(origin),
            unbatch(dropped))


def sort_segments(keys: torch.Tensor, *,
                  algo: Optional[str] = None) -> torch.Tensor:
    """Sort each row ascending (``algo``: pinned, or None to autotune)."""
    n, s = keys.shape
    resolved = resolve_sort_algo(n, s, keys.dtype, algo, kv=False,
                                 device=keys.device)
    if resolved == "oracle":
        return ref.sort_segments_ref(keys)
    if resolved == "radix":
        return sort_segments_radix(keys)
    return sort_segments_bitonic(keys)


def sort_kv_segments(keys: torch.Tensor, values: torch.Tensor, *,
                     algo: Optional[str] = None):
    """Sort each row of (keys, values) by key. ``"radix"`` and
    ``"oracle"`` are stable, ``"bitonic"`` is not (callers needing
    stability check :func:`repro_torch.kernels.autotune.is_stable` on the
    :func:`resolve_sort_algo` result)."""
    n, s = keys.shape
    resolved = resolve_sort_algo(n, s, keys.dtype, algo, kv=True,
                                 device=keys.device)
    if resolved == "oracle":
        return ref.sort_kv_segments_ref(keys, values)
    if resolved == "radix":
        return sort_kv_segments_radix(keys, values)
    return sort_kv_segments_bitonic(keys, values)
