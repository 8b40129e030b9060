"""MapReduce as a special case of Sphere (paper §3.6), stacked ranks.

Port of ``repro/core/mapreduce.py``. "A MapReduce map process can be
expressed directly by a Sphere process that writes the output stream to
local storage. A MapReduce reduce process can be simulated by the
hashing/bucket process of Sphere." The pipeline is::

    df = (Dataflow.source()
          .map(lambda r: {"key": r["word"],
                          "value": torch.ones_like(r["word"])})
          .shuffle(by=lambda r: default_hash(r["key"], nb), num_buckets=nb)
          .reduce(lambda r, v: ...reduce_by_key_sum(r["key"], r["value"], v)))
    SPMDExecutor(Ranks(8)).run(df, records)

``map_reduce`` is the deprecated shim over it, kept for parity with the
JAX package; its UDFs see one rank's segment at a time, as they see one
device's in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.comm import Ranks
from repro_torch.core.udf import per_rank
from repro_torch.kernels import ops as kops

#: Knuth's multiplicative constant (2^32 / golden ratio), as the JAX hash.
_HASH_MUL = 2654435761


def default_hash(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Multiplicative hash -> int32 bucket id, equal to the JAX package's
    uint32 arithmetic: ``((uint32(key) * 2654435761) mod 2^32) >> 16``,
    modulo ``num_buckets``. Computed in int64 from 16-bit halves of the key
    so that no product passes 2^63."""
    k = keys.to(torch.int64) & 0xFFFFFFFF
    lo, hi = k & 0xFFFF, k >> 16
    h = (lo * _HASH_MUL + (((hi * _HASH_MUL) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return ((h >> 16) % num_buckets).to(torch.int32)


def map_reduce(map_udf: Callable, reduce_udf: Callable, data,
               ranks: Optional[Ranks] = None,
               axis=None, num_buckets: Optional[int] = None,
               capacity_factor: float = 4.0,
               hash_fn: Callable = default_hash):
    """Run Map -> bucket shuffle -> Reduce over rank-stacked ``data``
    ``(ranks, n, ...)``.

    .. deprecated:: use :class:`repro_torch.sphere.dataflow.Dataflow`
       directly.

    map_udf:    one rank's segment -> (keys (m,), values (m,)) emitted pairs
                (m static; emit-nothing is encoded by key = -1). A segment
                with a trailing record axis is flattened first, as in JAX.
    reduce_udf: (keys, values, valid) of one rank's received buckets ->
                (out_keys, out_values) or (out_keys, out_values, dropped).
    ``axis`` names the rank axes to shuffle over (default: all).
    Returns (keys, values, valid, dropped), stacked ``(ranks, slots)``;
    ``dropped`` counts shuffle capacity overflow plus any drops the reduce
    UDF reports (e.g. :func:`reduce_by_key_sum` truncation).
    """
    from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

    ranks = ranks if ranks is not None else Ranks()
    nb = num_buckets or ranks.axis_size(axis)

    def emit_one(seg):
        if seg.dim() > 1:
            seg = seg.reshape((-1,) + tuple(seg.shape[2:]))
        keys, values = map_udf(seg)
        return {"key": keys, "value": values}

    def bucket_of(rec):
        # key < 0 = emit nothing (never sent, never counted as dropped)
        return torch.where(rec["key"] < 0, -1, hash_fn(rec["key"], nb))

    def reduce_one(keys, values, valid):
        out = reduce_udf(keys, values, valid)
        dropped = (torch.as_tensor(out[2], dtype=torch.int32)
                   if len(out) > 2 else torch.zeros((), dtype=torch.int32))
        return out[0], out[1], dropped.to(out[0].device)

    def reduce_stage(rec, valid):
        out_k, out_v, dropped = per_rank(reduce_one, rec["key"],
                                          rec["value"], valid)
        return {"key": out_k, "value": out_v}, out_k >= 0, dropped

    df = (Dataflow.source()
          .map(lambda data: per_rank(emit_one, data))
          .shuffle(by=bucket_of, num_buckets=nb,
                   capacity_factor=capacity_factor)
          .reduce(reduce_stage))
    res = SPMDExecutor(ranks, axes=axis).run(df, data)
    return res.records["key"], res.records["value"], res.valid, res.dropped


def reduce_by_key_sum(keys: torch.Tensor, values: torch.Tensor,
                      valid: torch.Tensor, max_unique: Optional[int] = None,
                      algo: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Built-in Reduce UDF: sum values per key (wordcount / inverted-index
    aggregation), per rank.

    ``keys``/``values``/``valid``: ``(n,)`` for one rank, or ``(ranks, n)``
    stacked — the form the port's reduce UDFs receive. All rows are sorted
    in ONE :func:`repro_torch.kernels.ops.sort_kv_segments` call of
    ``ranks`` rows (``algo`` pins ``"bitonic"`` / ``"radix"`` /
    ``"oracle"``; None autotunes), then each row's runs of equal keys are
    summed and each run's head (key, total) is scattered to slot = run
    index. Integer runs are summed exactly, as differences of int64 prefix
    sums over the flat buffer, so the unstable bitonic network's tie order
    does not change integer results. Float runs are each summed on their
    own in the value dtype (one ``torch.segment_reduce`` over the runs), as
    the JAX package's ``at[seg_id].add``: a run's total never depends on
    the values of other runs, and the same input gives the same bits on
    every run.

    Returns (unique_keys, sums, dropped): keys/sums ``(..., max_unique or
    n)`` with key = -1 padding rows; ``dropped`` — per row, ``(ranks,)`` or
    ``()`` — counts the distinct keys that did not fit in ``max_unique``
    (the executor sums it, as JAX's psums it). Values keep their dtype. A
    real key equal to the int32 maximum is the sort's padding key and is
    not reported, as in the JAX package.
    """
    single = keys.dim() == 1
    k2 = keys.reshape(1, -1) if single else keys
    v2 = values.reshape(1, -1) if single else values
    ok = valid.reshape(k2.shape).to(torch.bool)
    world, n = k2.shape
    dev = k2.device
    cap = max_unique or n
    sentinel = int(kops.pad_sentinel(torch.int32))
    skey = torch.where(ok, k2.to(torch.int32), sentinel).contiguous()
    pos = torch.arange(n, dtype=torch.int32,
                       device=dev).expand(world, n).contiguous()
    sk, order = kops.sort_kv_segments(skey, pos, algo=algo)
    sv = torch.take_along_dim(torch.where(ok, v2, torch.zeros_like(v2)),
                              order.to(torch.int64), dim=1)
    is_head = torch.ones((world, n), dtype=torch.bool, device=dev)
    is_head[:, 1:] = sk[:, 1:] != sk[:, :-1]
    # prefix sums run over the flattened rows: a scan along a few very long
    # rows is far slower on the card than one scan of the whole buffer
    heads = torch.cumsum(is_head.reshape(-1), dim=0).reshape(world, n)
    seg_id = heads - heads[:, :1]                            # run per entry
    real_head = is_head & (sk != sentinel)
    dropped = (real_head & (seg_id >= cap)).sum(dim=1, dtype=torch.int32)
    # every run's head, row-major (one host sync); a run ends where the
    # next head of its row starts, so the runs tile the flat buffer
    hr, hp = is_head.nonzero(as_tuple=True)
    end = torch.full_like(hp, n)
    if hp.numel() > 1:
        end[:-1] = torch.where(hr[1:] == hr[:-1], hp[1:], n)
    if hp.numel() == 0:
        total = sv.reshape(-1)
    elif sv.dtype.is_floating_point:
        # one segmented sum over the runs: a float run's total never
        # carries the rounding of the runs before it, and its order of
        # summation is fixed (no atomics), so reruns agree bit for bit
        total = torch.segment_reduce(sv.reshape(-1), "sum",
                                     lengths=end - hp)
    else:
        # a run's total is a difference of exclusive int64 prefix sums
        csum = torch.zeros((world * n + 1,), dtype=torch.int64, device=dev)
        torch.cumsum(sv.reshape(-1).to(torch.int64), dim=0, out=csum[1:])
        total = (csum[hr * n + end] - csum[hr * n + hp]).to(sv.dtype)
    run = seg_id[hr, hp]
    keep = real_head[hr, hp] & (run < cap)
    # kept heads land in slot = run index; the rest in one overflow column
    slot = torch.where(keep, run, cap)
    out_k = torch.full((world, cap + 1), -1, dtype=torch.int32, device=dev)
    out_k[hr, slot] = torch.where(keep, sk[hr, hp], -1)
    out_v = torch.zeros((world, cap + 1), dtype=sv.dtype, device=dev)
    out_v[hr, slot] = torch.where(keep, total, torch.zeros_like(total))
    out_k, out_v = out_k[:, :cap], out_v[:, :cap]
    if single:
        return out_k[0], out_v[0], dropped[0]
    return out_k, out_v, dropped
