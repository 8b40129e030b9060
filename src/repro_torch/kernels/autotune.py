"""Device-aware sort-kernel autotuner: measure once, cache, replay.

Port of ``repro/kernels/autotune.py``. Three interchangeable
implementations back :func:`repro_torch.kernels.ops.sort_segments` /
``sort_kv_segments``:

- ``"bitonic"`` — the Hopper bitonic network (K3; not stable),
- ``"radix"``   — the Hopper stable LSD radix sort (K2),
- ``"oracle"``  — the plain ``torch.sort`` path (stable), the counterpart
  of the JAX package's XLA sort outside Pallas. An algorithm choice, not a
  fallback.

Backends are ``"cuda"`` and ``"cpu"``. On the CPU the kernels are not
candidates — they cannot run there — and every choice records that as a
skip reason. The cell key is ``(kv, dtype, num_segments, segment_len,
backend)``: where the JAX package's key ends in its backend and Pallas
mode (``...|cpu|interp``), the port's ends in ``cuda`` or ``cpu``, so a
table measured by one package never matches the other's cells.

Resolution order (first hit wins):

1. ``REPRO_KERNEL_FORCE=radix|bitonic|oracle`` — unconditional override,
2. the in-process cache (each cell is measured at most once —
   :data:`MEASUREMENTS`),
3. a table entry: :func:`load_table`, or the file ``REPRO_AUTOTUNE_TABLE``
   names, read once (``benchmarks/kernel_bench.py``'s layout,
   ``{"results": {"autotune_table": {"entries": {...}}}}``, where
   ``"results"`` and ``"entries"`` may each be left out, so that
   ``autotune_table`` holds the bare ``key -> algo`` mapping; a missing or
   unreadable file is ignored, as is a file without ``autotune_table``),
4. below :data:`MIN_MEASURE_ELEMS`, or with ``REPRO_AUTOTUNE=0``: the
   static default ``"oracle"`` (on the card too: the user's switch, not a
   fallback),
5. measure every eligible candidate on synthetic data of the cell's shape
   (CUDA events), pick the fastest. A candidate outside its envelope is
   skipped with a recorded reason. A kernel that fails raises: the tuner
   never hides a broken kernel behind the oracle.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Mapping

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bitonic_sort import (sort_kv_segments_bitonic,
                                              sort_segments_bitonic)
from repro_torch.kernels.radix_sort import (radix_supported,
                                            sort_kv_segments_radix,
                                            sort_segments_radix)

ALGOS = ("bitonic", "radix", "oracle")

#: algorithms that preserve the input order of equal keys.
STABLE_ALGOS = frozenset({"radix", "oracle"})

FORCE_ENV = "REPRO_KERNEL_FORCE"
TABLE_ENV = "REPRO_AUTOTUNE_TABLE"
MEASURE_ENV = "REPRO_AUTOTUNE"

BACKENDS = ("cuda", "cpu")

#: cells smaller than this take the static default instead of measuring.
MIN_MEASURE_ELEMS = 1 << 14

_MEASURE_ITERS = 3

_CPU_SKIP = ("CUDA kernel: not a candidate on the cpu backend (CPU tensors "
             "take the plain version)")


@dataclasses.dataclass(frozen=True)
class Choice:
    """Resolved algorithm for one cell.

    source: "forced" | "cached" | "table" | "static" | "measured".
    melem:  algo -> measured throughput (Melem/s); measured cells only.
    skipped: algo -> reason it was not a candidate.
    """
    algo: str
    source: str
    melem: Mapping[str, float] = dataclasses.field(default_factory=dict)
    skipped: Mapping[str, str] = dataclasses.field(default_factory=dict)


#: cell key -> times that cell was actually measured.
MEASUREMENTS: "collections.Counter[str]" = collections.Counter()

_cache: Dict[str, Choice] = {}
_cached_view: Dict[str, Choice] = {}
_table: Dict[str, str] = {}
_table_loaded = False


def cell_key(num_segments: int, segment_len: int, dtype: torch.dtype,
             kv: bool, backend: str) -> str:
    """Stable string id of an autotune cell — also the JSON table key."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    name = str(dtype).replace("torch.", "")
    return (f"{'kv' if kv else 'keys'}|{name}|{num_segments}x{segment_len}"
            f"|{backend}")


def reset() -> None:
    """Drop every cached choice, loaded table and measurement count."""
    _cache.clear()
    _cached_view.clear()
    _table.clear()
    MEASUREMENTS.clear()
    global _table_loaded
    _table_loaded = False


def is_stable(algo: str) -> bool:
    return algo in STABLE_ALGOS


def load_table(table: Mapping[str, object]) -> None:
    """Pre-load ``cell key -> algo`` choices (values may be the dicts
    :func:`export_table` writes)."""
    for k, v in table.items():
        algo = v["algo"] if isinstance(v, Mapping) else v
        if algo in ALGOS:
            _table[str(k)] = algo


def export_table() -> Dict[str, Dict]:
    """JSON-ready ``cell key -> {algo, source, melem, skipped}`` snapshot of
    every resolved cell."""
    return {k: {"algo": c.algo, "source": c.source,
                "melem": dict(c.melem), "skipped": dict(c.skipped)}
            for k, c in _cache.items()}


def _load_table_env() -> None:
    global _table_loaded
    if _table_loaded:
        return
    _table_loaded = True
    path = os.environ.get(TABLE_ENV)
    if not path or not os.path.exists(path):
        return
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return
    results = doc.get("results", doc)
    table = results.get("autotune_table", {})
    load_table(table.get("entries", table) if isinstance(table, Mapping)
               else {})


def _synth(num_segments: int, segment_len: int, dtype: torch.dtype,
           kv: bool, device: torch.device):
    rng = np.random.default_rng(0)
    shape = (num_segments, segment_len)
    if dtype == torch.float32:
        keys = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    elif dtype == torch.uint32:
        keys = torch.from_numpy(
            rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
            .astype(np.uint32).view(np.int32)).view(torch.uint32)
    else:
        keys = torch.from_numpy(
            rng.integers(0, (1 << 31) - 1, size=shape, dtype=np.int64)
            .astype(np.int32))
    keys = keys.to(device)
    if not kv:
        return (keys,)
    vals = torch.arange(num_segments * segment_len, dtype=torch.int32,
                        device=device).reshape(shape)
    return keys, vals


def candidate(algo: str, kv: bool) -> Callable:
    if algo == "oracle":
        return ref.sort_kv_segments_ref if kv else ref.sort_segments_ref
    if algo == "bitonic":
        return sort_kv_segments_bitonic if kv else sort_segments_bitonic
    return sort_kv_segments_radix if kv else sort_segments_radix


def _time(fn: Callable, args, device: torch.device) -> float:
    """Best-of-N seconds (the first call builds/warms and is discarded)."""
    fn(*args)
    best = float("inf")
    for _ in range(_MEASURE_ITERS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn(*args)
            dt = time.perf_counter() - t0
        best = min(best, dt)
    return best


def _measure(num_segments: int, segment_len: int, dtype: torch.dtype,
             kv: bool, device: torch.device) -> Choice:
    n_elem = num_segments * segment_len
    melem: Dict[str, float] = {}
    skipped: Dict[str, str] = {}
    args = _synth(num_segments, segment_len, dtype, kv, device)
    for algo in ALGOS:
        reason = None
        if algo != "oracle" and device.type != "cuda":
            reason = _CPU_SKIP
        elif algo == "radix":
            reason = radix_supported(segment_len, num_segments)
        if reason is not None:
            skipped[algo] = reason
            continue
        melem[algo] = n_elem / _time(candidate(algo, kv), args, device) / 1e6
    best = max(melem, key=lambda a: melem[a])
    return Choice(best, "measured", melem=melem, skipped=skipped)


def _static(device: torch.device) -> Choice:
    skipped = ({} if device.type == "cuda"
               else {"bitonic": _CPU_SKIP, "radix": _CPU_SKIP})
    return Choice("oracle", "static", skipped=skipped)


def choose(num_segments: int, segment_len: int, dtype: torch.dtype, *,
           kv: bool = True, device="cuda") -> Choice:
    """Resolve the sort algorithm for one cell on ``device`` (see the
    module docstring for the resolution order)."""
    forced = os.environ.get(FORCE_ENV)
    if forced:
        if forced not in ALGOS:
            raise ValueError(f"{FORCE_ENV}={forced!r}: expected one of "
                             f"{ALGOS}")
        return Choice(forced, "forced")
    device = torch.device(device)
    key = cell_key(num_segments, segment_len, dtype, kv, device.type)
    hit = _cached_view.get(key)
    if hit is not None:
        return hit
    _load_table_env()
    if key in _table:
        choice = Choice(_table[key], "table")
    elif (num_segments * segment_len < MIN_MEASURE_ELEMS
          or os.environ.get(MEASURE_ENV) == "0"):
        choice = _static(device)
    else:
        choice = _measure(num_segments, segment_len, dtype, kv, device)
        MEASUREMENTS[key] += 1
    _cache[key] = choice
    _cached_view[key] = dataclasses.replace(choice, source="cached")
    return choice
