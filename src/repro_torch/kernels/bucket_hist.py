"""K4: int32 bucket histogram.

Port of ``repro/kernels/bucket_hist.py`` (``bucket_histogram_pallas``, the
Pallas ``_hist_kernel``): the count of ids per bucket, ids outside
``[0, num_buckets)`` ignored, exact past 2^24 (int32 counters).

On a CUDA tensor this launches the hand-written Hopper kernel
``csrc/bucket_hist.cu``; on a CPU tensor it takes the plain version
(:func:`repro_torch.kernels.ref.bucket_histogram_ref`). Nothing else.

Bound on the H100: memory (4 B read per id). The TPU kernel accumulated a
``ones @ one_hot`` MXU product into one output block resident across a
sequential grid; here a bounded grid of blocks streams the ids with
16-byte loads into a shared-memory histogram a block (plain atomics) and
flushes each block's bins into the output, which the C entry point
zeroes first (see the CUDA source).
:func:`hist_plan` is what the wrapper hands to the C entry point.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, require_cuda

KERNEL = Kernel("bucket_hist",
                replaces="src/repro/kernels/bucket_hist.py:54")

MAX_NUM_BUCKETS = 4096
#: grid.y carries the row.
MAX_ROWS = 65535
#: csrc/bucket_hist.cu's k4:: constants
THREADS = 256
VEC = 4                  # ids a 16-byte load
BLOCKS = 512             # aimed for over all rows
MIN_CHUNK = 16384        # a row gets at most ceil(n / MIN_CHUNK) blocks


class HistPlan(NamedTuple):
    """One kernel call: a memset of the output, then one launch of
    ``blocks_per_row`` x rows blocks."""

    chunk: int             # ids a block counts (a multiple of VEC)
    blocks_per_row: int
    blocks: int
    threads: int           # per block
    smem_bytes: int        # the block's histogram
    scratch_bytes: int     # none: the output is zeroed in place
    cuda_launches: int
    memsets: int


def hist_plan(rows: int, n: int, num_buckets: int) -> HistPlan:
    """The plan for a ``(rows, n)`` call into ``num_buckets`` buckets;
    raises outside the kernel's envelope. The C entry point refuses a call
    whose chunk or blocks differ from its own layout."""
    if not 1 <= num_buckets <= MAX_NUM_BUCKETS:
        raise ValueError(f"num_buckets={num_buckets} outside the kernel "
                         f"envelope [1, {MAX_NUM_BUCKETS}]")
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows exceed the kernel envelope "
                         f"({MAX_ROWS})")
    if rows < 1 or n < 1:
        raise ValueError(f"an empty call ({rows}, {n}) launches nothing")
    per_row = max(1, min(-(-n // MIN_CHUNK), BLOCKS // rows))
    chunk = -(-(-(-n // per_row)) // VEC) * VEC
    per_row = -(-n // chunk)
    return HistPlan(chunk=chunk, blocks_per_row=per_row,
                    blocks=per_row * rows, threads=THREADS,
                    smem_bytes=4 * num_buckets, scratch_bytes=0,
                    cuda_launches=1, memsets=1)


def bucket_histogram(bucket_ids: torch.Tensor,
                     num_buckets: int) -> torch.Tensor:
    """int32 count of ids per bucket; ids outside ``[0, num_buckets)``
    count nothing. ``bucket_ids``: int32 ``(n,)`` -> ``(num_buckets,)``, or
    ``(rows, n)`` -> ``(rows, num_buckets)``."""
    if bucket_ids.dtype != torch.int32:
        raise TypeError(f"bucket_ids must be int32, got {bucket_ids.dtype}")
    if bucket_ids.dim() not in (1, 2):
        raise ValueError(f"bucket_ids must be (n,) or (rows, n), got "
                         f"{tuple(bucket_ids.shape)}")
    if not 1 <= num_buckets <= MAX_NUM_BUCKETS:
        raise ValueError(f"num_buckets={num_buckets} outside the kernel "
                         f"envelope [1, {MAX_NUM_BUCKETS}]")
    if bucket_ids.device.type == "cpu":
        return ref.bucket_histogram_ref(bucket_ids, num_buckets)
    require_cuda(bucket_ids)
    rows2 = bucket_ids.reshape(1, -1) if bucket_ids.dim() == 1 else bucket_ids
    rows2 = rows2.contiguous()
    r, n = rows2.shape
    if r > MAX_ROWS:
        raise ValueError(f"{r} rows exceed the kernel envelope ({MAX_ROWS})")
    if n == 0 or r == 0:
        out = torch.zeros((r, num_buckets), dtype=torch.int32,
                          device=bucket_ids.device)
    else:
        plan = hist_plan(r, n, num_buckets)
        out = torch.empty((r, num_buckets), dtype=torch.int32,
                          device=bucket_ids.device)
        KERNEL.launch("bucket_hist_launch", rows2, out, r, n, num_buckets,
                      plan.chunk, plan.blocks_per_row)
    return out[0] if bucket_ids.dim() == 1 else out
