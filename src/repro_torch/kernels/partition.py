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
sequential grid; Hopper blocks run in no order, so the kernel is one
sweep of a chained scan with decoupled look-back: each block ranks one
tile stably by ballots, publishes its per-destination counts as status
words and takes its base from the row's earlier tiles (see the CUDA
source). :func:`partition_plan` is what the wrapper hands to the C entry
point.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, require_cuda

KERNEL = Kernel("partition",
                replaces="src/repro/kernels/partition.py:89")

MAX_NUM_DEST = 4096
MAX_ROWS = 65535
#: ranks are int32 positions inside a row.
MAX_ROW_LEN = (1 << 31) - 1
#: ids a thread (k1::kItems in csrc/partition.cu); a warp owns 32 x ITEMS
#: consecutive ids of its block's tile
ITEMS = 24
#: up to NARROW_DEST destinations a block is 16 warps (a 12288-id tile),
#: above it 4 warps (3072), so that per-warp counters fit in shared memory.
NARROW_DEST = 1024
NARROW_WARPS, WIDE_WARPS = 16, 4
#: scratch: a 64-byte header (the tile counter), then (tiles, rows,
#: num_dest) int64 look-back status words.
HEADER_BYTES = 64


class PartitionPlan(NamedTuple):
    """One kernel call: one launch of ``blocks`` blocks, one tile each,
    after one memset of the scratch."""

    tile: int
    tiles: int             # per row
    blocks: int            # rows * tiles
    threads: int           # per block
    ballots: int           # per 32 ids: ceil(log2(num_dest + 1))
    smem_bytes: int        # per-warp counters and tile totals, int32
    scratch_bytes: int     # tile counter + status words
    cuda_launches: int
    memsets: int


def partition_plan(rows: int, n: int, num_dest: int) -> PartitionPlan:
    """The plan for a ``(rows, n)`` call with ``num_dest`` destinations;
    raises outside the kernel's envelope. The C entry point refuses a call
    whose tile, tiles or scratch bytes differ from its own layout."""
    if not 1 <= num_dest <= MAX_NUM_DEST:
        raise ValueError(f"num_dest={num_dest} outside the kernel envelope "
                         f"[1, {MAX_NUM_DEST}]")
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows exceed the kernel envelope "
                         f"({MAX_ROWS})")
    if n > MAX_ROW_LEN:
        raise ValueError(f"a row of {n} ids exceeds the kernel envelope "
                         f"({MAX_ROW_LEN})")
    if rows < 1 or n < 1:
        raise ValueError(f"an empty call ({rows}, {n}) launches nothing")
    warps = NARROW_WARPS if num_dest <= NARROW_DEST else WIDE_WARPS
    tile = warps * 32 * ITEMS
    tiles = -(-n // tile)
    return PartitionPlan(
        tile=tile, tiles=tiles, blocks=rows * tiles, threads=32 * warps,
        ballots=num_dest.bit_length(),
        smem_bytes=4 * (warps + 1) * num_dest,
        scratch_bytes=HEADER_BYTES + 8 * rows * tiles * num_dest,
        cuda_launches=1, memsets=1)


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
    if n == 0 or r == 0:
        counts = torch.zeros((r, num_dest), dtype=torch.int32,
                             device=dest.device)
    else:
        plan = partition_plan(r, n, num_dest)
        counts = torch.empty((r, num_dest), dtype=torch.int32,
                             device=dest.device)
        scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                              device=dest.device)
        KERNEL.launch("partition_rank_launch", rows2, rank, counts, scratch,
                      plan.scratch_bytes, r, n, num_dest, plan.tile,
                      plan.tiles)
    if dest.dim() == 1:
        return rank[0], counts[0]
    return rank, counts
