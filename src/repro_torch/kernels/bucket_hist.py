"""K4: int32 bucket histogram.

Port of ``repro/kernels/bucket_hist.py`` (``bucket_histogram_pallas``, the
Pallas ``_hist_kernel``): the count of ids per bucket, ids outside
``[0, num_buckets)`` ignored, exact past 2^24 (int32 counters).

On a CUDA tensor this launches the hand-written Hopper kernel
``csrc/bucket_hist.cu``; on a CPU tensor it takes the plain version
(:func:`repro_torch.kernels.ref.bucket_histogram_ref`). Nothing else.

Bound on the H100: memory (4 B read per id). The TPU kernel accumulated a
``ones @ one_hot`` MXU product into one output block resident across a
sequential grid; here each block keeps a shared-memory histogram fed by
warp-aggregated increments (``__match_any_sync`` + ``__popc``) and
flushes its non-zero bins into the output with global atomics.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, require_cuda

KERNEL = Kernel("bucket_hist",
                replaces="src/repro/kernels/bucket_hist.py:54")

#: shared-memory envelope: one int32 counter per bucket per block (16 KB).
MAX_NUM_BUCKETS = 4096
#: grid.y carries the row.
MAX_ROWS = 65535


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
    out = torch.zeros((r, num_buckets), dtype=torch.int32,
                      device=bucket_ids.device)
    if n > 0 and r > 0:
        KERNEL.launch("bucket_hist_launch", rows2, out, r, n, num_buckets)
    return out[0] if bucket_ids.dim() == 1 else out
