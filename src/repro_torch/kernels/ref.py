"""Plain PyTorch versions of the kernels (the "oracles").

Counterparts of ``repro/kernels/ref.py``: the semantics each Hopper kernel
must match. The kernel wrappers take these only for tensors on the CPU
(the tests); ``chip_smoke.py`` holds each kernel against them on the card.

Every function accepts a leading batch of rows, the stacked-ranks layout
of :mod:`repro_torch.comm`: where the JAX oracle takes ``(n,)`` the port
takes ``(n,)`` or ``(rows, n)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: elements of one-hot plane materialised per chunk by the counting oracles.
_ONEHOT_BUDGET = 1 << 24


def _as_rows(ids: torch.Tensor) -> torch.Tensor:
    ids = ids.to(torch.int32)
    return ids.reshape(1, -1) if ids.dim() <= 1 else ids


def bucket_histogram_ref(bucket_ids: torch.Tensor,
                         num_buckets: int) -> torch.Tensor:
    """int32 count of records per bucket; ids outside [0, num_buckets) are
    ignored. ``(n,)`` -> ``(num_buckets,)``; ``(rows, n)`` -> ``(rows,
    num_buckets)``."""
    rows = _as_rows(bucket_ids)
    cols = torch.arange(num_buckets, dtype=torch.int32, device=rows.device)
    out = torch.zeros((rows.shape[0], num_buckets), dtype=torch.int32,
                      device=rows.device)
    tile = max(1, _ONEHOT_BUDGET // max(rows.shape[0] * num_buckets, 1))
    for start in range(0, rows.shape[1], tile):
        oh = rows[:, start:start + tile, None] == cols
        out += oh.sum(dim=1, dtype=torch.int32)
    return out[0] if bucket_ids.dim() <= 1 else out


def partition_rank_ref(dest: torch.Tensor, num_dest: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (stable rank, histogram) of the destination vector.

    ``rank[i]`` counts earlier records (same row) with the same
    destination; ``counts[d]`` is destination d's total. Out-of-range ids
    (< 0 or >= num_dest) count nothing and get rank 0 (unspecified by the
    contract). A one-hot cumsum over chunks carrying the per-destination
    base, as the JAX oracle's scan does.

    ``(n,)`` -> ``(rank (n,), counts (num_dest,))``; ``(rows, n)`` ->
    ``(rank (rows, n), counts (rows, num_dest))``, all int32.
    """
    rows = _as_rows(dest)
    r, n = rows.shape
    rank = torch.zeros((r, n), dtype=torch.int32, device=rows.device)
    counts = torch.zeros((r, num_dest), dtype=torch.int32, device=rows.device)
    cols = torch.arange(num_dest, dtype=torch.int32, device=rows.device)
    tile = max(1, _ONEHOT_BUDGET // max(r * num_dest, 1))
    for start in range(0, n, tile):
        oh = rows[:, start:start + tile, None] == cols       # (r, t, D)
        cum = torch.cumsum(oh.to(torch.int32), dim=1, dtype=torch.int32)
        within = torch.where(oh, cum - 1 + counts[:, None, :], 0)
        rank[:, start:start + tile] = within.sum(dim=2, dtype=torch.int32)
        counts += cum[:, -1, :]
    if dest.dim() <= 1:
        return rank[0], counts[0]
    return rank, counts


def _sort_order(keys: torch.Tensor) -> torch.Tensor:
    if keys.dtype == torch.uint32:      # sort the unsigned value, not bits
        keys = keys.to(torch.int64)
    return torch.argsort(keys, dim=-1, stable=True)


def sort_segments_ref(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of each row independently (same shape/dtype)."""
    return _take_rows(keys, _sort_order(keys))


def sort_kv_segments_ref(keys: torch.Tensor, values: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of each row of (key, value) pairs by key."""
    order = _sort_order(keys)
    return _take_rows(keys, order), _take_rows(values, order)


def _take_rows(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``take_along_dim`` for 32-bit payloads of any dtype (torch has no
    gather for uint32 on the CPU, so move the bits as int32)."""
    if values.dtype == torch.uint32:
        return torch.take_along_dim(values.view(torch.int32), order,
                                    dim=-1).view(torch.uint32)
    return torch.take_along_dim(values, order, dim=-1)
