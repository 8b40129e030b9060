"""K3: row sort of (key, payload) pairs — ascending, NOT stable.

Port of ``repro/kernels/bitonic_sort.py`` (``sort_kv_segments_pallas`` /
``sort_segments_pallas``, the Pallas ``_bitonic_kernel``, ``pallas_call``
at ``:117``). Same function: each row sorted ascending by key
(int32/uint32/float32), each 32-bit payload beside its key, the order
among equal keys unspecified; callers needing stability use the radix
kernel.

On a CUDA tensor this launches ``csrc/bitonic_sort.cu``; on a CPU tensor
it takes the plain version (:func:`repro_torch.kernels.ref.sort_kv_segments_ref`,
a stable sort, which satisfies the unstable contract).

Bound on the H100: memory, 16 bytes per kv element (keys and payloads
read once, written once). The TPU kernel held a whole row in VMEM, so its
network's O(log^2 s) depth cost no memory traffic; on the card the
main-path rows (2^23 + 8) are far past shared memory, and running the
network over device memory took 91 launches and 47.45 ms (NVIDIA H100
80GB HBM3, 700 W; PERF.md). The kernel now makes 1 + ceil(log2(s / T))
passes, each one read and one write of one 8-byte word per element (key
bits high, payload low): a block sort of T = 8192-element tiles (the
bitonic network inside each warp's 512 elements, in registers and warp
shuffles, then merge-path merges of the warp runs in shared memory), then
pairwise merge-path merges of the sorted runs across device memory (see
the CUDA source). Nothing is padded in memory: slots past the row's end
are read as the all-ones word, which sorts after every real element, and
nothing past ``s`` is written. At (8, 2^23 + 8) int32 kv it takes
5.86 ms in 23 launches on that card (``chip_smoke.py``; PERF.md §6, K3).

:func:`pass_plan` is the plan the wrapper hands to the C entry point:
tile size, merge passes and the buffer each pass writes.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, require_cuda

KERNEL = Kernel("bitonic_sort",
                replaces="src/repro/kernels/bitonic_sort.py:117")

#: key dtype -> the C entry point's key_mode
KEY_MODES = {torch.uint32: 0, torch.int32: 1, torch.float32: 2}
#: grid.y carries the row.
MAX_ROWS = 65535
#: merge-path splits are int32 positions inside a row.
MAX_SEGMENT_LEN = (1 << 31) - 1
TILE = 8192    # k3::kTile in csrc/bitonic_sort.cu: one block-sort tile
CHUNK = 4096   # k3::kChunk: the outputs one merge block writes


class PassPlan(NamedTuple):
    """One kernel call's passes: the block sort writes ``writes[0]``,
    merge pass p (1-based) reads ``writes[p - 1]`` and writes
    ``writes[p]``; ``writes[-1]`` is always ``"out"`` (the unpacked
    keys and payloads)."""

    tile: int
    tiles: int                 # per row
    chunks: int                # merge blocks per row and pass
    merge_passes: int
    writes: Tuple[str, ...]    # "scratch0" / "scratch1" / "out"
    scratch_buffers: int       # (rows, s) 8-byte words each
    cuda_launches: int         # block sort + (partition, merge) per pass


def pass_plan(rows: int, s: int) -> PassPlan:
    """The plan for a ``(rows, s)`` call; raises outside the kernel's
    envelope (``rows`` up to :data:`MAX_ROWS`, ``s`` up to
    :data:`MAX_SEGMENT_LEN`)."""
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows exceed the kernel envelope "
                         f"({MAX_ROWS})")
    if s > MAX_SEGMENT_LEN:
        raise ValueError(f"segment length {s} exceeds the kernel envelope "
                         f"({MAX_SEGMENT_LEN})")
    if rows < 1 or s < 1:
        raise ValueError(f"empty sort ({rows}, {s}) launches nothing")
    tiles = -(-s // TILE)
    passes = (tiles - 1).bit_length()          # ceil(log2(tiles))
    writes: List[str] = [f"scratch{p % 2}" for p in range(passes)] + ["out"]
    return PassPlan(tile=TILE, tiles=tiles, chunks=-(-s // CHUNK),
                    merge_passes=passes, writes=tuple(writes),
                    scratch_buffers=min(passes, 2),
                    cuda_launches=1 + 2 * passes)


def check_sort_args(keys: torch.Tensor, values) -> None:
    if keys.dim() != 2:
        raise ValueError(f"keys must be (rows, segment_len), got "
                         f"{tuple(keys.shape)}")
    if keys.dtype not in KEY_MODES:
        raise TypeError(f"sort kernels take int32/uint32/float32 keys, got "
                        f"{keys.dtype}")
    if values is not None:
        if values.shape != keys.shape:
            raise ValueError(f"values {tuple(values.shape)} != keys "
                             f"{tuple(keys.shape)}")
        if values.element_size() != 4:
            raise TypeError(f"payload must be a 32-bit dtype, got "
                            f"{values.dtype}")
        if values.device != keys.device:
            raise ValueError("keys and values on different devices")


def _bitonic(keys: torch.Tensor, values) -> Tuple[torch.Tensor, object]:
    require_cuda(keys, *([] if values is None else [values]))
    n, s = keys.shape
    if n == 0 or s == 0:
        return keys.clone(), None if values is None else values.clone()
    plan = pass_plan(n, s)
    dev = keys.device
    k_in = keys.contiguous().view(torch.int32)
    out_k = torch.empty((n, s), dtype=torch.int32, device=dev)
    v_in = out_v = None
    if values is not None:
        v_in = values.contiguous().view(torch.int32)
        out_v = torch.empty((n, s), dtype=torch.int32, device=dev)
    scratch = [torch.empty((n, s), dtype=torch.int64, device=dev)
               for _ in range(plan.scratch_buffers)]
    scratch += [None] * (2 - len(scratch))
    splits = (torch.empty((n, plan.chunks), dtype=torch.int32, device=dev)
              if plan.merge_passes else None)
    KERNEL.launch("bitonic_sort_launch", k_in, v_in, out_k, out_v,
                  scratch[0], scratch[1], splits, n, s, plan.merge_passes,
                  KEY_MODES[keys.dtype])
    return (out_k.view(keys.dtype),
            None if out_v is None else out_v.view(values.dtype))


def sort_kv_segments_bitonic(keys: torch.Tensor, values: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each row of ``keys`` ascending, permuting ``values`` (any
    32-bit dtype) alongside. Not stable."""
    check_sort_args(keys, values)
    if keys.device.type == "cpu":
        return ref.sort_kv_segments_ref(keys, values)
    return _bitonic(keys, values)


def sort_segments_bitonic(keys: torch.Tensor) -> torch.Tensor:
    """Keys-only row sort (no payload moves)."""
    check_sort_args(keys, None)
    if keys.device.type == "cpu":
        return ref.sort_segments_ref(keys)
    return _bitonic(keys, None)[0]
