"""K3: bitonic sort of (key, payload) rows — ascending, NOT stable.

Port of ``repro/kernels/bitonic_sort.py`` (``sort_kv_segments_pallas`` /
``sort_segments_pallas``, the Pallas ``_bitonic_kernel``). Semantics kept
from the TPU kernel: each row is padded to the next power of two (at
least 2) with the key dtype's maximum (+inf for floats) and a zero
payload, sorted by the same compare-exchange network, and sliced back.
Ties (including real keys equal to the padding sentinel) may come out in
any order; callers needing stability use the radix kernel.

On a CUDA tensor this launches ``csrc/bitonic_sort.cu``; on a CPU tensor
it takes the plain version (:func:`repro_torch.kernels.ref.sort_kv_segments_ref`,
a stable sort, which satisfies the unstable contract).

Bound on the H100: memory. The TPU kernel held a whole row in VMEM; the
main-path rows are 2^24 long after padding, so stages whose partner
distance reaches the 4096-element shared-memory tile run as passes over
device memory and the shorter ones inside one shared-memory kernel per
tile (see the CUDA source).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, require_cuda

KERNEL = Kernel("bitonic_sort",
                replaces="src/repro/kernels/bitonic_sort.py:117")

#: key dtype -> (C key_mode, int32 bit pattern of the padding sentinel)
KEY_MODES = {torch.uint32: (0, -1),            # 0xFFFFFFFF
             torch.int32: (1, 0x7FFFFFFF),
             torch.float32: (2, 0x7F800000)}   # +inf
MAX_ROWS = 65535


def next_pow2(x: int) -> int:
    """Padded row length: next power of two, at least 2 (as the TPU
    kernel's ``_next_pow2``)."""
    return 1 << max(1, (x - 1).bit_length())


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
    if n > MAX_ROWS:
        raise ValueError(f"{n} rows exceed the kernel envelope ({MAX_ROWS})")
    if n == 0 or s == 0:
        return keys.clone(), None if values is None else values.clone()
    mode, sentinel_bits = KEY_MODES[keys.dtype]
    s_pad = next_pow2(s)
    k = torch.full((n, s_pad), sentinel_bits, dtype=torch.int32,
                   device=keys.device)
    k[:, :s] = keys.view(torch.int32)
    v = None
    if values is not None:
        v = torch.zeros((n, s_pad), dtype=torch.int32, device=keys.device)
        v[:, :s] = values.view(torch.int32)
    KERNEL.launch("bitonic_sort_launch", k, v, n, s_pad.bit_length() - 1,
                  mode)
    out_k = k[:, :s].view(keys.dtype)
    out_v = None if v is None else v[:, :s].view(values.dtype)
    return out_k, out_v


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
