"""Sphere streams (paper §3.2), stacked ranks.

Port of ``repro/core/stream.py``. "A stream ... represents either a dataset
or a part of a dataset. Sphere takes streams as inputs and produces streams
as outputs. A Sphere stream consists of multiple data segments and the
segments are processed by Sphere Processing Engines (SPEs)."

Here a stream is a record array split along its leading axis over
:class:`repro_torch.comm.Ranks`: :meth:`SphereStream.shard` turns the
global ``(N, ...)`` array into the rank-stacked ``(ranks, N / ranks,
...)`` form, whose row r *is* the segment rank r processes (the JAX
package's per-device block). ``plan_segments`` is the host-level segment
table of the paper's scheduler (§3.5.1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import Ranks
from repro_torch.core.records import tree_flatten, tree_map

#: Paper defaults for segment sizing (§3.5.1), in records here rather than MB.
S_MIN_DEFAULT = 8 << 20
S_MAX_DEFAULT = 128 << 20


@dataclasses.dataclass(frozen=True)
class SegmentInfo:
    """Host-level segment descriptor: which records, from which Sector file."""
    index: int
    file_path: str
    offset: int
    num_records: int


def _global_np(a: Any, stacked: bool) -> np.ndarray:
    """A leaf as a numpy array in the global ``(N, ...)`` layout."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)
    return a.reshape((-1,) + a.shape[2:]) if stacked else a


@dataclasses.dataclass
class SphereStream:
    """A record array (or tree of them) plus its segment table.

    ``data``: global ``(num_records, ...)`` leaves, or — once
    :meth:`shard` has run, ``ranks`` set — rank-stacked ``(ranks, n, ...)``
    leaves. ``valid``: optional bool mask of the same leading shape —
    Sphere outputs may be padded (capacity-bounded shuffles), and
    downstream UDFs must know which rows are real records. ``codec``:
    optional :class:`repro_torch.core.records.RecordCodec` describing the
    record schema.
    """

    data: Any
    valid: Optional[Any] = None
    segment_table: Optional[List[SegmentInfo]] = None
    codec: Optional[object] = None
    ranks: Optional[Ranks] = None

    @property
    def num_records(self) -> int:
        leaf = tree_flatten(self.data)[0][0]
        if self.ranks is not None:
            return int(leaf.shape[0]) * int(leaf.shape[1])
        return int(leaf.shape[0])

    def with_data(self, data: Any, valid: Optional[Any] = None,
                  ranks: Optional[Ranks] = None) -> "SphereStream":
        # codec intentionally not carried over: a UDF may change the schema
        return SphereStream(data=data, valid=valid,
                            segment_table=self.segment_table, ranks=ranks)

    # -- sharding -------------------------------------------------------------
    def shard(self, ranks: Ranks) -> "SphereStream":
        """Split the global records over ``ranks`` (contiguous blocks, rank
        r holding rows ``[r * n, (r + 1) * n)``, as ``P(axis)`` shards) and
        move the ranks' rows to their device (all of them stacked, a
        process's own under :class:`repro_torch.comm.ProcessRanks`)."""
        if self.ranks is not None:
            raise ValueError("stream is already sharded")

        def split(a):
            t = torch.as_tensor(np.asarray(a) if not isinstance(
                a, torch.Tensor) else a)
            if t.shape[0] % ranks.world:
                raise ValueError(f"{t.shape[0]} records do not shard over "
                                 f"{ranks.world} ranks")
            t = t.reshape((ranks.world, -1) + tuple(t.shape[1:]))
            return ranks.stack(t.contiguous())

        return SphereStream(
            data=tree_map(split, self.data),
            valid=None if self.valid is None else split(self.valid),
            segment_table=self.segment_table, codec=self.codec, ranks=ranks)

    # -- micro-batching -------------------------------------------------------
    def micro_batches(self, batch_records: int,
                      drop_remainder: bool = False):
        """Yield the stream as dense numpy record chunks of at most
        ``batch_records`` rows, in global record order. Rows masked out by
        ``valid`` are compacted away first, so every yielded row is a real
        record."""
        if batch_records <= 0:
            raise ValueError(f"batch_records must be > 0, got "
                             f"{batch_records}")
        stacked = self.ranks is not None
        data = tree_map(lambda a: _global_np(a, stacked), self.data)
        if self.valid is not None:
            mask = _global_np(self.valid, stacked).astype(bool)
            data = tree_map(lambda a: a[mask], data)
        n = tree_flatten(data)[0][0].shape[0]
        for off in range(0, n, batch_records):
            end = min(off + batch_records, n)
            if drop_remainder and end - off < batch_records:
                return
            yield tree_map(lambda a: a[off:end], data)

    # -- segment bookkeeping --------------------------------------------------
    @staticmethod
    def plan_segments(total_records: int, record_bytes: int,
                      files: Sequence[Tuple[str, int]],
                      s_min: int = S_MIN_DEFAULT, s_max: int = S_MAX_DEFAULT,
                      num_spes: int = 1) -> List[SegmentInfo]:
        """Paper §3.5.1 segmentation: uniform split across SPEs, clamped to
        [S_min, S_max] bytes, whole records only, never spanning files.

        ``files``: (sector_path, num_records) per input file.
        """
        if total_records == 0:
            return []
        target = max(1, total_records // max(num_spes, 1))
        min_rec = max(1, math.ceil(s_min / record_bytes))
        max_rec = max(1, s_max // record_bytes)
        per_seg = min(max(target, min_rec), max_rec)
        segs: List[SegmentInfo] = []
        idx = 0
        for path, nrec in files:
            off = 0
            while off < nrec:
                n = min(per_seg, nrec - off)
                segs.append(SegmentInfo(idx, path, off, n))
                idx += 1
                off += n
        return segs


def make_stream(data: Any, ranks: Optional[Ranks] = None) -> SphereStream:
    """A stream of ``data`` (global ``(N, ...)``), sharded over ``ranks``
    when given."""
    s = SphereStream(data=data)
    if ranks is not None:
        s = s.shard(ranks)
    return s
