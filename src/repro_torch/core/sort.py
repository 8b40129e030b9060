"""Distributed Terasort (paper §4.2, Fig 3) and the Hadoop-style baseline.

Port of ``repro/core/sort.py``. ``terasort`` is a thin shim over the
dataflow API — the whole two-stage sort is one pipeline::

    Dataflow.source().sort(key=lambda r: r["key"], splitters=...,
                           num_buckets=...)

run by :class:`repro_torch.sphere.dataflow.SPMDExecutor` over stacked
ranks. Stage 1 range-partitions keys into buckets (``searchsorted``
against the splitters) and shuffles each record to the rank owning its
bucket; stage 2 regroups and sorts each rank's buckets. After stage 2 the
valid keys of rank d precede those of rank d+1.

``hadoop_style_sort`` is the paper's Table 1 baseline: every reducer reads
the complete map output (an ``all_gather``), filters its own key range
and sorts it — D× the bytes of the direct bucket shuffle.

Inputs and outputs are rank-stacked: keys ``(ranks, n_local)``; results
``(ranks, slots)`` (:mod:`repro_torch.interop` converts to and from the
JAX package's global layout). Under
:class:`repro_torch.comm.ProcessRanks` ``terasort`` takes and returns the
process's own row, ``(1, n_local)`` and ``(1, slots)``;
``hadoop_style_sort`` takes the global stacked arrays and keeps that row
(``ranks.stack``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.comm import Ranks
from repro_torch.core.shuffle import ShufflePlan
from repro_torch.kernels import ops as kops
from repro_torch.sphere.dataflow import (_KEY_MAX, Dataflow, SPMDExecutor,
                                         default_splitters)

KEY_MAX = _KEY_MAX


@dataclasses.dataclass
class SortResult:
    """keys/payload/valid: ``(ranks, slots)``; the valid records of rank d
    are ascending and all precede rank d+1's. dropped: ``()`` int32."""
    keys: torch.Tensor
    payload: torch.Tensor
    valid: torch.Tensor
    dropped: torch.Tensor


def uniform_splitters(num_buckets: int, key_min: int = 0,
                      key_max: int = KEY_MAX, device="cuda") -> torch.Tensor:
    """Equal-width int32 range splitters (terasort keys are uniform),
    computed in float32 as the JAX package does."""
    return torch.from_numpy(default_splitters(num_buckets, key_min,
                                              key_max)).to(device)


def sampled_splitters(keys: torch.Tensor, num_buckets: int,
                      sample_per_shard: int, ranks: Ranks) -> torch.Tensor:
    """Sample-based splitters for non-uniform keys: every rank contributes
    a strided sample; quantiles of the gathered sample become the
    thresholds (paper §3.6)."""
    n = keys.shape[1]
    take = min(sample_per_shard, n)
    stride = max(n // take, 1)
    samp = keys[:, :take * stride:stride]
    ssorted = torch.sort(ranks.all_gather(samp)).values
    m = ssorted.shape[0]
    idx = (torch.arange(1, num_buckets, device=keys.device) * m) // num_buckets
    return ssorted[idx]


def _as_splitters(splitters, num_buckets: int, device) -> torch.Tensor:
    if splitters is None:
        return uniform_splitters(num_buckets, device=device)
    spl = torch.as_tensor(np.asarray(splitters)
                          if not isinstance(splitters, torch.Tensor)
                          else splitters)
    if spl.shape[0] != num_buckets - 1:
        raise ValueError(f"{spl.shape[0]} splitters for "
                         f"{num_buckets} buckets")
    return spl.to(device=device, dtype=torch.int32)


def terasort(keys, payload, ranks: Optional[Ranks] = None,
             axis: Union[str, Sequence[str], None] = None,
             splitters=None, capacity_factor: float = 2.0,
             use_pallas: bool = True, buckets_per_device: int = 1,
             plan: Optional[ShufflePlan] = None,
             chunks: Optional[int] = None,
             sort_algo: Optional[str] = None) -> SortResult:
    """Globally sort rank-stacked (keys, payload).

    keys: ``(ranks, n_local)`` int32 >= 0; payload: ``(ranks, n_local)``
    int32 (e.g. the record index into the 90-byte values). ``ranks``
    defaults to ``Ranks()`` (8 ranks on the card). ``axis`` names the rank
    axes to shuffle over (default: all of them): one axis is the flat
    bucket shuffle, a ``(dc_axis, node_axis)`` pair the wide-area
    two-level shuffle of :mod:`repro_torch.core.shuffle`, keeping cross-DC
    traffic to one dense tile per remote data center. ``sort_algo`` pins
    the stage-2 sort (``"bitonic"`` / ``"radix"`` / ``"oracle"``); ``None``
    defers to ``use_pallas`` (``True`` -> bitonic, ``False`` -> the
    autotuner). An explicit ``plan`` overrides ``axis``,
    ``buckets_per_device`` and ``capacity_factor``.
    """
    ranks = ranks if ranks is not None else Ranks()
    if plan is not None:
        axes = plan.axes
        num_buckets = plan.num_buckets
    else:
        axes = ranks.axis_names(axis)
        num_buckets = ranks.axis_size(axes) * buckets_per_device
    spl = _as_splitters(splitters, num_buckets, ranks.device)
    df = Dataflow.source().sort(key=lambda r: r["key"], splitters=spl,
                                num_buckets=num_buckets,
                                capacity_factor=capacity_factor)
    ex = SPMDExecutor(ranks, axes=axes, plan=plan, use_pallas=use_pallas,
                      chunks=chunks, sort_algo=sort_algo)
    res = ex.run(df, {"key": torch.as_tensor(keys).to(torch.int32),
                      "payload": torch.as_tensor(payload)})
    return SortResult(keys=res.records["key"],
                      payload=res.records["payload"],
                      valid=res.valid, dropped=res.dropped)


def hadoop_style_sort(keys, payload, ranks: Optional[Ranks] = None,
                      splitters=None,
                      algo: Optional[str] = None) -> SortResult:
    """Baseline: every reducer pulls the complete map output, keeps its
    own key range and sorts it (one ``all_gather`` each for keys and
    payload). Same valid keys as :func:`terasort`; moves D× the bytes.
    ``algo`` pins the local sort, ``None`` autotunes."""
    ranks = ranks if ranks is not None else Ranks()
    dev = ranks.device
    keys = ranks.stack(keys, torch.int32)
    payload = ranks.stack(payload)
    n_local = keys.shape[1]
    spl = _as_splitters(splitters, ranks.world, dev)
    all_k = ranks.all_gather(keys)                     # (N,) on every rank
    all_p = ranks.all_gather(payload)
    bucket = torch.searchsorted(spl, all_k, right=True, out_int32=True)
    mine = bucket[None, :] == ranks.axis_index()[:, None]      # (R, N)
    cap = n_local * 2
    skey = torch.where(mine, all_k[None, :], KEY_MAX)
    pos = torch.arange(all_k.shape[0], dtype=torch.int32,
                       device=dev).expand(ranks.rows, -1).contiguous()
    sk, order = kops.sort_kv_segments(skey, pos, algo=algo)
    order = order[:, :cap].to(torch.int64)
    sk = sk[:, :cap]
    sp = all_p[order]
    sv = torch.take_along_dim(mine, order, dim=1)
    return SortResult(keys=sk.contiguous(), payload=sp, valid=sv,
                      dropped=torch.zeros((), dtype=torch.int32, device=dev))


def is_globally_sorted(result: SortResult, num_devices: int) -> bool:
    """Host-side check: valid keys ascend within each rank block and block
    maxima never exceed the next block's minima."""
    keys = result.keys.reshape(-1).cpu().numpy()
    valid = result.valid.reshape(-1).cpu().numpy()
    per = keys.shape[0] // num_devices
    prev_max = -1
    for d in range(num_devices):
        k = keys[d * per:(d + 1) * per][valid[d * per:(d + 1) * per]]
        if k.size == 0:
            continue
        if not bool(np.all(np.diff(k) >= 0)):
            return False
        if k[0] < prev_max:
            return False
        prev_max = int(k[-1])
    return True
