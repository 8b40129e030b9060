"""K1: fused per-destination histogram + stable counting rank.

Port of ``repro/kernels/partition.py`` (``partition_rank_pallas``, the
Pallas ``_rank_kernel``). The shuffle send path and the stage-2 regroup
need, per record, ``rank[i]`` = how many earlier records share record i's
destination, and per destination the total count — one pass, no sort.

On a CUDA tensor this launches the hand-written Hopper kernel
``csrc/partition.cu``; on a CPU tensor it takes the plain version
(:func:`repro_torch.kernels.ref.partition_rank_ref`). Nothing else.

Bound on the H100: memory (4 B read and 4 B written per record). The TPU
kernel kept a running base in a revisited output block across a
sequential grid; Hopper blocks run in no order, so the kernel is three
launches — per-tile histogram, scan over tiles, per-tile rank with
``__match_any_sync`` — see ``csrc/multisplit.cuh``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, require_cuda

KERNEL = Kernel("partition",
                replaces="src/repro/kernels/partition.py:89")

#: shared-memory envelope: 8 warps x num_dest int32 counters <= 128 KB.
MAX_NUM_DEST = 4096
#: grid.y carries the row.
MAX_ROWS = 65535
TILE = 4096  # ms::kTile in csrc/multisplit.cuh


def partition_rank(dest: torch.Tensor, num_dest: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable rank within destination and per-destination counts.

    ``dest``: int32 ``(n,)`` or ``(rows, n)``. Returns ``(rank, counts)``:
    int32 ``(n,)``/``(num_dest,)`` or ``(rows, n)``/``(rows, num_dest)``.
    Ids outside ``[0, num_dest)`` count nothing; their rank is 0.
    """
    if dest.dtype != torch.int32:
        raise TypeError(f"dest must be int32, got {dest.dtype}")
    if dest.dim() not in (1, 2):
        raise ValueError(f"dest must be (n,) or (rows, n), got "
                         f"{tuple(dest.shape)}")
    if not 1 <= num_dest <= MAX_NUM_DEST:
        raise ValueError(f"num_dest={num_dest} outside the kernel envelope "
                         f"[1, {MAX_NUM_DEST}]")
    if dest.device.type == "cpu":
        return ref.partition_rank_ref(dest, num_dest)
    require_cuda(dest)
    rows2 = dest.reshape(1, -1) if dest.dim() == 1 else dest
    rows2 = rows2.contiguous()
    r, n = rows2.shape
    if r > MAX_ROWS:
        raise ValueError(f"{r} rows exceed the kernel envelope ({MAX_ROWS})")
    rank = torch.empty((r, n), dtype=torch.int32, device=dest.device)
    counts = torch.zeros((r, num_dest), dtype=torch.int32, device=dest.device)
    if n > 0:
        tiles = -(-n // TILE)
        hist = torch.empty((r, num_dest, tiles), dtype=torch.int32,
                           device=dest.device)
        KERNEL.launch("partition_rank_launch", rows2, rank, counts, hist,
                      r, n, num_dest)
    if dest.dim() == 1:
        return rank[0], counts[0]
    return rank, counts
