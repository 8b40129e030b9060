"""K2: stable LSD radix sort of (key, payload) rows.

Port of ``repro/kernels/radix_sort.py`` (``sort_kv_segments_radix`` /
``sort_segments_radix``, the Pallas ``_make_radix_kernel``). Keys
(int32/uint32/float32; NaN unsupported) map through an order-preserving
bijection onto unsigned 32-bit "sortable bits", sort as 4 passes of 8-bit
digits, and map back; -0.0 orders before +0.0. A 32-bit payload moves
bit-exactly. Stable: equal keys keep their input order, so — unlike the
bitonic network — no key value is reserved for padding.

On a CUDA tensor this launches ``csrc/radix_sort.cu``; on a CPU tensor it
takes the plain LSD radix below (:func:`sort_kv_segments_radix_ref`).

Bound on the H100: memory. Two TPU-only pieces are not carried over: the
one-hot matmul permutation (Mosaic has no scatter; CUDA scatters
natively) and the 4 MiB VMEM envelope. The kernel is a one-sweep LSD
radix sort (CUB's Onesweep): one launch reads the keys once and counts all
four digits of every row, then one launch per digit ranks each
8192-element tile stably, finds the tile's place among the row's earlier
tiles by decoupled look-back, and writes keys and payloads out through
shared memory in digit order (see the CUDA source). That is 68 bytes a
kv element in five launches. :func:`radix_plan` is what the wrapper
hands to the C entry point; the port's envelope (:func:`radix_supported`)
is the CUDA grid's.

The bijection and the plain radix work on int32 bit patterns: torch on
the CPU has no shift or ``~`` for uint32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.bitonic_sort import KEY_MODES, check_sort_args
from repro_torch.kernels.build import Kernel, require_cuda

KERNEL = Kernel("radix_sort",
                replaces="src/repro/kernels/radix_sort.py:227")

#: digit width of every pass (4 passes over 32-bit keys).
BITS = 8
PASSES = 32 // BITS
#: the histogram's grid.y carries the row; positions inside a row are int32.
MAX_ROWS = 65535
MAX_SEGMENT_LEN = (1 << 31) - 1
TILE = 8192  # k2::kTile in csrc/radix_sort.cu: one pass block's tile
#: scratch: the passes' tile counters (k2::kHeaderInts int32), then
#: (rows, PASSES, 256) int32 digit counts, then (rows, tiles, 256) int64
#: look-back status words shared by all passes.
HEADER_BYTES = 64

_SIGN = -(1 << 31)           # 0x80000000 as an int32


# -- order-preserving key <-> uint32 bijections ------------------------------


def key_to_sortable_bits(keys: torch.Tensor) -> torch.Tensor:
    """Map int32/uint32/float32 keys onto uint32 so that unsigned order
    equals key order (monotone bijection)."""
    if keys.dtype == torch.uint32:
        return keys
    if keys.dtype == torch.int32:
        return (keys ^ _SIGN).view(torch.uint32)
    if keys.dtype == torch.float32:
        bits = keys.view(torch.int32)
        return torch.where(bits < 0, ~bits, bits | _SIGN).view(torch.uint32)
    raise TypeError(f"radix sort supports int32/uint32/float32 keys, "
                    f"got {keys.dtype}")


def sortable_bits_to_key(bits: torch.Tensor, dtype: torch.dtype
                         ) -> torch.Tensor:
    """Inverse of :func:`key_to_sortable_bits`."""
    if dtype == torch.uint32:
        return bits
    b = bits.view(torch.int32)
    if dtype == torch.int32:
        return b ^ _SIGN
    if dtype == torch.float32:
        # sign bit of the sortable form set <=> the key was non-negative
        return torch.where(b < 0, b & 0x7FFFFFFF, ~b).view(torch.float32)
    raise TypeError(f"radix sort supports int32/uint32/float32 keys, "
                    f"got {dtype}")


def radix_supported(segment_len: int, num_segments: int = 1
                    ) -> Optional[str]:
    """None when the Hopper kernel's envelope covers the cell, else the
    reason (callers record it — never a silent skip)."""
    if segment_len > MAX_SEGMENT_LEN:
        return (f"segment_len={segment_len} exceeds the int32 position "
                f"range of the CUDA radix kernel ({MAX_SEGMENT_LEN})")
    if num_segments > MAX_ROWS:
        return (f"{num_segments} segments exceed the CUDA grid's "
                f"{MAX_ROWS} rows")
    return None


class RadixPlan(NamedTuple):
    """One kernel call: a histogram launch, then one launch per digit
    pass; pass p reads the input (p = 0) or ``writes[p - 1]`` and writes
    ``writes[p]``."""

    tile: int
    tiles: int                 # per row
    writes: Tuple[str, ...]    # "tmp" / "out", one per pass
    scratch_bytes: int         # counters, histograms, status words
    cuda_launches: int         # 1 histogram + 1 per pass
    memsets: int               # of the scratch, once a call


def radix_plan(rows: int, s: int, kv: bool = True) -> RadixPlan:
    """The plan for a ``(rows, s)`` call, with a payload (``kv``) or
    keys-only, which share one plan; raises outside the kernel's envelope
    (``rows`` up to :data:`MAX_ROWS`, ``s`` up to :data:`MAX_SEGMENT_LEN`).
    The C entry point refuses a call whose tiles or scratch bytes differ
    from its own layout."""
    reason = radix_supported(s, rows)
    if reason is not None:
        raise ValueError(reason)
    if rows < 1 or s < 1:
        raise ValueError(f"empty sort ({rows}, {s}) launches nothing")
    tiles = -(-s // TILE)
    radix = 1 << BITS
    scratch = HEADER_BYTES + 4 * rows * PASSES * radix + 8 * rows * tiles * radix
    return RadixPlan(tile=TILE, tiles=tiles,
                     writes=tuple("tmp" if p % 2 == 0 else "out"
                                  for p in range(PASSES)),
                     scratch_bytes=scratch,
                     cuda_launches=1 + PASSES, memsets=1)


# -- plain version (CPU) -----------------------------------------------------


def sort_kv_segments_radix_ref(keys: torch.Tensor, values) -> Tuple:
    """Plain LSD radix, 8-bit digits: per pass, a stable sort of the rows
    by digit. Same arithmetic as the kernel on int32 bit patterns."""
    bits = key_to_sortable_bits(keys).view(torch.int32)
    vals = None if values is None else values.view(torch.int32)
    for shift in range(0, 32, BITS):
        digit = (bits >> shift) & ((1 << BITS) - 1)
        order = torch.argsort(digit, dim=-1, stable=True)
        bits = torch.take_along_dim(bits, order, dim=-1)
        if vals is not None:
            vals = torch.take_along_dim(vals, order, dim=-1)
    out_k = sortable_bits_to_key(bits.view(torch.uint32), keys.dtype)
    out_v = None if vals is None else vals.view(values.dtype)
    return out_k, out_v


# -- kernel wrappers ---------------------------------------------------------


def _radix(keys: torch.Tensor, values) -> Tuple:
    require_cuda(keys, *([] if values is None else [values]))
    n, s = keys.shape
    reason = radix_supported(s, n)
    if reason is not None:
        raise ValueError(f"radix kernel unsupported here: {reason}")
    if n == 0 or s == 0:
        return keys.clone(), None if values is None else values.clone()
    plan = radix_plan(n, s, values is not None)
    dev = keys.device
    k_in = keys.contiguous().view(torch.int32)
    out_k = torch.empty((n, s), dtype=torch.int32, device=dev)
    tmp_k = torch.empty_like(out_k)
    v_in = out_v = tmp_v = None
    if values is not None:
        v_in = values.contiguous().view(torch.int32)
        out_v = torch.empty_like(out_k)
        tmp_v = torch.empty_like(out_k)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    KERNEL.launch("radix_sort_launch", k_in, v_in, out_k, out_v, tmp_k, tmp_v,
                  scratch, plan.scratch_bytes, n, s, plan.tiles,
                  KEY_MODES[keys.dtype])
    return (out_k.view(keys.dtype),
            None if out_v is None else out_v.view(values.dtype))


def sort_kv_segments_radix(keys: torch.Tensor, values: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-sort each row of ``keys`` ascending, permuting ``values``
    (any 32-bit dtype, moved bit-exactly) alongside."""
    check_sort_args(keys, values)
    if keys.device.type == "cpu":
        return sort_kv_segments_radix_ref(keys, values)
    return _radix(keys, values)


def sort_segments_radix(keys: torch.Tensor) -> torch.Tensor:
    """Keys-only row sort (no payload moves)."""
    check_sort_args(keys, None)
    if keys.device.type == "cpu":
        return sort_kv_segments_radix_ref(keys, None)[0]
    return _radix(keys, None)[0]
