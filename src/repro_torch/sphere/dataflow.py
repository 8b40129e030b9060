"""Unified Sphere dataflow: one pipeline description, two executors.

Port of ``repro/sphere/dataflow.py``: the pipeline description,
``SPMDExecutor`` and ``HostExecutor`` (chaos/resume, streaming carry and
per-stage tracing are not ported yet). A :class:`Dataflow` is a
declarative chain of stages over *records* — any fixed-shape dict / tuple
/ list tree of tensors sharing leading record axes::

    df = Dataflow.source().sort(key=lambda r: r["key"], splitters=...)
    res = SPMDExecutor(Ranks(8)).run(df, records)        # paper §4.2
    grid = Ranks(shape=(2, 4), axes=("dc", "node"))
    res = SPMDExecutor(grid).run(df, records)            # wide area, §2.2
    res = HostExecutor(master, client, spes).run(df, sector_paths)  # §2-3

:class:`SPMDExecutor` runs every stage once over all ranks of a
:class:`repro_torch.comm.Ranks` (records carry a leading rank axis):
maps and reduces inline per rank, shuffles as capacity-bounded
exchanges through :class:`repro_torch.core.shuffle.ShufflePlan` (one
``all_to_all`` over a flat axis, two over a ``(dc, node)`` grid), and a
sort stage as the two-stage terasort — a range-partition shuffle, then a
bucket-major regroup (kernel K1) and one multi-segment sort (kernel K3 or
K2, or the ``torch.sort`` oracle).

:class:`HostExecutor` runs the same pipeline on the Sector/SPE data
plane (:mod:`repro_torch.sphere.engine`): SPEs decode Sector segments onto
the executor's device, run the phase's UDFs there, and shuffle and sort
stages materialize bucket files back into Sector, which the next phase
reads — the paper's own architecture. Its per-segment work runs two of the
port's kernels: the bucket split is K1 (:func:`repro_torch.kernels.partition.partition_rank`)
and a sort's stage-2 stable argsort is K2
(:func:`repro_torch.kernels.radix_sort.sort_kv_segments_radix`).

UDF contracts are the JAX package's: ``map(fn)`` maps records to records
(padding-oblivious); ``shuffle(by)`` gives bucket ids, negative meaning
"emit nothing"; ``reduce(fn)`` takes ``(records, valid)`` of one group and
returns ``(records, valid)`` or ``(records, valid, dropped)``. On
:class:`SPMDExecutor` the group is all ranks at once, each leaf leading
with the rank axis (``dropped`` a scalar or one count per rank, summed);
on :class:`HostExecutor` it is one segment or one bucket file, each leaf
leading with its ``(n,)`` record axis.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from collections import OrderedDict, namedtuple
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.comm import Ranks, resolve_device
from repro_torch.core.records import (RecordCodec, tree_flatten, tree_map,
                                      tree_unflatten)
from repro_torch.core.shuffle import ShufflePlan, record_hops
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as kops
from repro_torch.kernels import partition, radix_sort
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import NULL_TRACER

_KEY_MAX = int(np.iinfo(np.int32).max)


# -- pipeline description ----------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class MapStage:
    fn: Callable


@dataclasses.dataclass(frozen=True, eq=False)
class ShuffleStage:
    by: Callable
    num_buckets: Optional[int] = None
    capacity_factor: float = 4.0
    chunks: Optional[int] = None          # None -> executor default


@dataclasses.dataclass(frozen=True, eq=False)
class ReduceStage:
    fn: Callable


@dataclasses.dataclass(frozen=True, eq=False)
class SortStage:
    key: Callable
    splitters: Optional[Any] = None       # (num_buckets - 1,) int32 thresholds
    num_buckets: Optional[int] = None
    capacity_factor: float = 2.0
    chunks: Optional[int] = None          # None -> executor default


@dataclasses.dataclass(frozen=True, eq=False)
class Dataflow:
    """An immutable, chainable pipeline of stages (see module docstring).
    ``codec`` is the source record schema (optional for the SPMD
    executor, which infers it from the tensors it is handed)."""

    stages: Tuple[Any, ...] = ()
    codec: Optional[RecordCodec] = None

    @classmethod
    def source(cls, codec: Optional[RecordCodec] = None) -> "Dataflow":
        return cls(stages=(), codec=codec)

    def _with(self, stage) -> "Dataflow":
        return Dataflow(stages=self.stages + (stage,), codec=self.codec)

    def map(self, fn: Callable) -> "Dataflow":
        return self._with(MapStage(fn))

    def shuffle(self, by: Callable, num_buckets: Optional[int] = None,
                capacity_factor: float = 4.0,
                chunks: Optional[int] = None) -> "Dataflow":
        return self._with(ShuffleStage(by, num_buckets, capacity_factor,
                                       chunks))

    def reduce(self, fn: Callable) -> "Dataflow":
        return self._with(ReduceStage(fn))

    def sort(self, key: Callable, splitters: Optional[Any] = None,
             num_buckets: Optional[int] = None,
             capacity_factor: float = 2.0,
             chunks: Optional[int] = None) -> "Dataflow":
        return self._with(SortStage(key, splitters, num_buckets,
                                    capacity_factor, chunks))

    def describe(self) -> str:
        parts = ["source"]
        for st in self.stages:
            if isinstance(st, MapStage):
                parts.append(f"map[{getattr(st.fn, '__name__', '<fn>')}]")
            elif isinstance(st, ShuffleStage):
                parts.append(f"shuffle[{st.num_buckets or 'auto'}]")
            elif isinstance(st, ReduceStage):
                parts.append(f"reduce[{getattr(st.fn, '__name__', '<fn>')}]")
            elif isinstance(st, SortStage):
                parts.append(f"sort[{st.num_buckets or 'auto'}]")
        return " |> ".join(parts)

    def run(self, executor: Any, data: Any, **kwargs: Any) -> "DataflowResult":
        """The paper's §3.1 client call: ``df.run(executor, records)``."""
        return executor.run(self, data, **kwargs)


@dataclasses.dataclass
class DataflowResult:
    """Executor-independent result.

    records: output tree. SPMD: each leaf ``(ranks, slots, ...)`` — mask
             with ``valid`` ``(ranks, slots)``. Host: dense ``(n, ...)``
             tensors on the executor's device, ``valid`` all true.
    dropped: ``()`` int32 records lost to capacity bounds (SPMD shuffles)
             plus drops reported by reduce UDFs.
    errors/retries/recoveries/data_errors/phase_times: host-executor
             fault and time accounting (empty / 0 on SPMD).
    trace:   the tracer the run recorded into (None when untraced).
    """

    records: Any
    valid: torch.Tensor
    dropped: torch.Tensor
    #: host executor: segments that failed, keyed ``(phase, segment)``
    errors: Dict[Any, str] = dataclasses.field(default_factory=dict)
    retries: int = 0
    #: mid-job Sector re-replications of lost bucket files (host)
    recoveries: int = 0
    #: segments that permanently failed and are MISSING from ``records``
    #: (every one also appears in ``errors`` with a ``DATA_ERROR:`` prefix)
    data_errors: int = 0
    trace: Optional[Any] = None
    #: host executor: one dict per phase with wall-clock accounting
    #: (``seconds``, ``engine_s``, ``materialize_s``, segments, retries,
    #: recoveries, data_errors) — populated even without a tracer
    phase_times: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)


def _split_reduce_out(out):
    if not isinstance(out, tuple) or len(out) not in (2, 3):
        raise ValueError("reduce UDF must return (records, valid) or "
                         "(records, valid, dropped)")
    return out[0], out[1], (out[2] if len(out) == 3 else None)


def _leading(records) -> Tuple[int, int]:
    """(ranks, n) of a stacked records tree."""
    leaf = tree_flatten(records)[0][0]
    return int(leaf.shape[0]), int(leaf.shape[1])


def default_splitters(num_buckets: int, key_min: int = 0,
                      key_max: int = _KEY_MAX) -> np.ndarray:
    """Equal-width int32 range splitters of the SPMD path, computed in
    float32 the way XLA's CPU backend lowers ``jnp.linspace(key_min,
    key_max, nb + 1)[1:-1].astype(int32)`` with constant bounds:
    ``start * (1 - t) + i * (stop * r)`` with ``r = f32(1) / f32(nb)`` and
    ``t = i * r`` (XLA turns the division by the constant ``nb`` into a
    multiplication by its float32 reciprocal, and folds ``stop * r``),
    each operation rounded to float32, then truncated toward zero.

    On ``(0, INT32_MAX)``, the range both executors use, this equals the
    JAX package's splitters for every bucket count 2..1024, whether
    ``jnp.linspace`` runs inside a jitted program or eagerly. For other
    ranges it equals the jitted form below 353 buckets; the eager form
    (the JAX package's ``uniform_splitters(nb, key_min, key_max)`` called
    outside ``jit``) is compiled with the bounds as arguments, where the
    backend contracts some of these operations into fused multiply-adds
    depending on ``nb``, and differs by up to one float32 ulp of
    max(|key_min|, |key_max|) in some splitters (a known gap, pinned by
    ``tests/test_torch_terasort.py``). The host executor's splitters are
    float64 (:func:`host_splitters`)."""
    f32 = np.float32
    i = np.arange(num_buckets, dtype=f32)
    r = f32(1) / f32(num_buckets)
    edges = f32(key_min) * (f32(1) - i * r) + i * (f32(key_max) * r)
    return edges[1:].astype(np.int32)


def host_splitters(num_buckets: int) -> np.ndarray:
    """The host executor's default sort splitters: ``np.linspace`` in
    float64, as the JAX package's ``HostExecutor`` computes them — not the
    SPMD path's float32 ones (:func:`default_splitters`)."""
    return np.linspace(0, _KEY_MAX, num_buckets + 1)[1:-1].astype(np.int32)


#: ``SPMDExecutor.cache_info()`` result (``functools.lru_cache`` style plus
#: an eviction counter).
CacheInfo = namedtuple("CacheInfo",
                       ["hits", "misses", "evictions", "currsize", "maxsize"])


class _CacheEntry(NamedTuple):
    """What one (pipeline, plan, shapes, algo) cell derives once: the
    shuffle plan of every shuffle/sort stage, the resolved stage-2 sort
    algorithm, and the hop geometry the first run recorded."""

    pipeline: "Dataflow"
    plans: Dict[int, ShufflePlan]
    algos: Dict[int, str]
    has_sort: bool
    hops: List[dict]


# -- SPMD executor -----------------------------------------------------------


class SPMDExecutor:
    """Runs a :class:`Dataflow` over stacked ranks (see module docstring).

    ``axes`` are the rank axes the shuffles exchange over, as the JAX
    executor's ``axes=``: one axis gives the flat ``all_to_all``, a ``(dc,
    node)`` pair the two-level wide-area path. They must cover every rank
    (default: all axes of ``ranks``); an explicit ``plan`` brings its own.
    Every shuffle hop ships one fused wire tensor with no per-record
    metadata (``wire_meta="min"``): the executor regroups from the
    records themselves. ``chunks`` sets the pipeline depth of every hop
    (stage chunks > executor chunks > plan chunks > 1).

    ``sort_algo`` pins the stage-2 segment sort (``"bitonic"`` /
    ``"radix"`` / ``"oracle"``); ``None`` defers to the autotuner, except
    that ``use_pallas=True`` keeps the JAX package's meaning and pins
    ``"bitonic"``. ``REPRO_KERNEL_FORCE`` overrides both (and is part of
    the cache key).

    There is no compile step in eager PyTorch; the executor caches, per
    (pipeline, plan, input shapes/dtypes, algo), the shuffle plans and the
    resolved sort algorithm, in an LRU of ``cache_size`` entries with the
    JAX executor's hit/miss/eviction counters.

    ``debug_checks`` (on by default): after a sort, raise if a real key
    equals the padding sentinel (the key dtype's maximum) while the
    unstable bitonic kernel is selected — the network could swap it with
    padding. Stable algorithms keep such keys ahead of the padding, and
    the check is skipped. It costs one host sync per run.
    """

    def __init__(self, ranks: Optional[Ranks] = None,
                 axes: Optional[Sequence[str]] = None,
                 plan: Optional[ShufflePlan] = None,
                 use_pallas: bool = False,
                 chunks: Optional[int] = None,
                 cache_size: int = 32,
                 debug_checks: bool = True,
                 sort_algo: Optional[str] = None):
        self.ranks = ranks if ranks is not None else Ranks()
        if plan is not None:
            plan.check(self.ranks)
            self.axes = tuple(plan.axes)
        else:
            self.axes = self.ranks.axis_names(axes)
        if self.ranks.axis_size(self.axes) != self.ranks.world:
            raise ValueError(f"axes={self.axes} cover "
                             f"{self.ranks.axis_size(self.axes)} of "
                             f"{self.ranks.world} ranks")
        self.plan = plan
        self.sort_algo = (sort_algo if sort_algo is not None
                          else ("bitonic" if use_pallas else None))
        self.chunks = chunks
        self.cache_size = cache_size
        self.debug_checks = debug_checks
        # LRU keyed on (pipeline id, plan, shapes/dtypes); entries hold a
        # strong ref to the pipeline so its id() cannot be reused while
        # cached.
        self._cache: "OrderedDict[Any, _CacheEntry]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    @property
    def device(self) -> torch.device:
        return self.ranks.device

    @property
    def axis_size(self) -> int:
        return self.ranks.axis_size(self.axes)

    def cache_info(self) -> CacheInfo:
        return CacheInfo(self._hits, self._misses, self._evictions,
                         len(self._cache), self.cache_size)

    def run(self, pipeline: Dataflow, records: Any,
            valid: Optional[Any] = None,
            trace: Optional[Any] = None) -> DataflowResult:
        """Execute ``pipeline`` over rank-stacked ``records`` (each leaf
        ``(ranks, n, ...)``, numpy or tensors; moved to the ranks' device).

        ``trace``: a :class:`repro_torch.obs.trace.Tracer`; the run records
        ``spmd.run`` / ``spmd.execute`` spans (execute fenced with
        ``torch.cuda.synchronize`` on the card) and publishes the JAX
        executor's counters to the metrics registry.
        """
        tr = trace if trace is not None else NULL_TRACER
        dev = self.device
        records = tree_map(lambda a: torch.as_tensor(a).to(dev), records)
        world, n = _leading(records)
        if world != self.ranks.world:
            raise ValueError(f"records lead with {world} ranks, executor has "
                             f"{self.ranks.world}")
        if valid is None:
            valid = torch.ones((world, n), dtype=torch.bool, device=dev)
        else:
            valid = torch.as_tensor(valid).to(dev).reshape(world, n)
        leaves, treedef = tree_flatten(records)
        key = (id(pipeline), self.plan, self.axes, self.chunks, self.sort_algo,
               os.environ.get(autotune.FORCE_ENV), treedef,
               tuple((tuple(l.shape), l.dtype) for l in leaves), str(dev))
        with tr.span("spmd.run", pipeline=pipeline.describe(),
                     records=world * n) as root:
            entry = self._cache.get(key)
            miss = entry is None
            if miss:
                root.set(cache="miss")
                self._misses += 1
                REGISTRY.counter("spmd.cache.misses").inc()
                entry = _CacheEntry(
                    pipeline=pipeline, plans={}, algos={},
                    has_sort=any(isinstance(s, SortStage)
                                 for s in pipeline.stages),
                    hops=[])
            else:
                self._hits += 1
                REGISTRY.counter("spmd.cache.hits").inc()
                self._cache.move_to_end(key)
                root.set(cache="hit")
            a2a_before = self.ranks.collectives["all_to_all"]
            # the first run of a cell records its hop geometry
            with (tr.span("spmd.execute", hops=len(entry.hops)),
                  record_hops(entry.hops if miss else [])):
                out = self._body(pipeline, records, valid, entry)
                if tr.enabled and dev.type == "cuda":
                    # fence: the span must cover device time, not dispatch
                    torch.cuda.synchronize(dev)
            if miss:
                self._insert(key, entry)
            out_records, out_valid, dropped, sentinel_hits = out
            if (self.debug_checks and entry.has_sort
                    and sentinel_hits is not None
                    and int(sentinel_hits) > 0):
                raise ValueError(
                    f"{int(sentinel_hits)} record key(s) equal the key "
                    f"dtype's maximum — the stage-2 sort padding sentinel — "
                    f"while the unstable 'bitonic' kernel is selected: the "
                    f"network's tie order is unspecified, so they could "
                    f"silently swap with padding slots. Use a stable sort "
                    f"(sort_algo='radix' or 'oracle' — both deliver "
                    f"max-value keys correctly), rescale the keys, or pass "
                    f"debug_checks=False to accept the old silent "
                    f"behaviour.")
            a2a = self.ranks.collectives["all_to_all"] - a2a_before
            self._record_run(entry, world * n, dropped, a2a, tr, root)
        return DataflowResult(records=out_records, valid=out_valid,
                              dropped=dropped, trace=trace)

    def _insert(self, key, entry: _CacheEntry) -> None:
        self._cache[key] = entry
        if len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
            self._evictions += 1
            REGISTRY.counter("spmd.cache.evictions").inc()

    def _record_run(self, entry: _CacheEntry, n: int, dropped, a2a: int,
                    tr, root) -> None:
        """Publish per-run metrics. Drop counts force a device sync, so
        they are only recorded under an active tracer."""
        m = REGISTRY
        m.counter("spmd.runs").inc()
        m.counter("spmd.records_in").inc(n)
        wire = 0
        if entry.hops:
            wire = (sum(h["wire_bytes_per_device"] for h in entry.hops)
                    * self.axis_size)
            m.counter("spmd.shuffle.wire_bytes").inc(wire)
            m.counter("spmd.shuffle.hops").inc(len(entry.hops))
        if not tr.enabled:
            return
        d = int(dropped)
        m.counter("spmd.dropped").inc(d)
        m.counter("spmd.collectives.all_to_all").inc(a2a)
        root.set(dropped=d, wire_bytes=wire,
                 hops=[{k: h[k] for k in ("axis", "num_dest", "chunks",
                                          "wire_bytes_per_device")}
                       for h in entry.hops])

    # -- the stages, once over all ranks ---------------------------------------
    def _body(self, df: Dataflow, records, valid, entry: _CacheEntry):
        dropped = torch.zeros((), dtype=torch.int32, device=self.device)
        sentinel = None
        for i, stage in enumerate(df.stages):
            if isinstance(stage, MapStage):
                records = stage.fn(records)
                if _leading(records) != tuple(valid.shape):
                    valid = torch.ones(_leading(records), dtype=torch.bool,
                                       device=self.device)
            elif isinstance(stage, ReduceStage):
                records, valid, rd = _split_reduce_out(stage.fn(records, valid))
                valid = valid.reshape(_leading(records))
                if rd is not None:
                    rd = torch.as_tensor(rd, device=self.device)
                    dropped += rd.to(torch.int32).sum()
            elif isinstance(stage, ShuffleStage):
                ids = torch.as_tensor(stage.by(records)).reshape(valid.shape)
                records, valid, d = self._exchange(
                    records, valid, ids, stage.num_buckets,
                    stage.capacity_factor, stage.chunks, entry, i)
                dropped += d
            elif isinstance(stage, SortStage):
                records, valid, d, hits = self._sort(records, valid, stage,
                                                     entry, i)
                dropped += d
                if hits is not None:
                    sentinel = hits if sentinel is None else sentinel + hits
            else:
                raise TypeError(f"unknown stage {stage!r}")
        return records, valid, dropped, sentinel

    def _stage_plan(self, num_buckets: Optional[int], n_local: int,
                    capacity_factor: float,
                    chunks: Optional[int]) -> ShufflePlan:
        # precedence: stage chunks > executor chunks > plan chunks > 1
        w = chunks if chunks is not None else self.chunks
        if self.plan is not None:
            if num_buckets not in (None, self.plan.num_buckets):
                raise ValueError(
                    f"stage wants {num_buckets} buckets but the executor "
                    f"plan has {self.plan.num_buckets}")
            if w is None or w == self.plan.chunks:
                return self.plan
            return dataclasses.replace(self.plan, chunks=w)
        nb = num_buckets or self.axis_size
        return ShufflePlan.for_ranks(self.ranks, nb, n_local, capacity_factor,
                                     self.axes, chunks=1 if w is None else w)

    def _exchange(self, records, valid, ids, num_buckets, capacity_factor,
                  chunks, entry: _CacheEntry, i: int):
        """One bucket shuffle: pack -> plan.shuffle -> unpack. The wire
        carries pure payload rows (``wire_meta="min"``)."""
        codec = RecordCodec.from_example(records, batch_dims=2)
        packed = codec.pack(records)                        # (R, n, bytes)
        plan = entry.plans.get(i)
        if plan is None:
            plan = self._stage_plan(num_buckets, packed.shape[1],
                                    capacity_factor, chunks)
            entry.plans[i] = plan
        res = plan.shuffle(self.ranks, packed, ids.to(torch.int32),
                           valid=valid, wire_meta="min")
        del packed
        flat = res.data.reshape(self.ranks.world, -1, codec.nbytes)
        return (codec.unpack(flat), res.valid.reshape(self.ranks.world, -1),
                res.dropped)

    def _splitters(self, stage: SortStage, nb: int) -> torch.Tensor:
        if stage.splitters is not None:
            spl = torch.as_tensor(np.asarray(stage.splitters)
                                  if not isinstance(stage.splitters,
                                                    torch.Tensor)
                                  else stage.splitters)
            if spl.shape[0] != nb - 1:
                raise ValueError(f"{spl.shape[0]} splitters for {nb} buckets")
        else:
            spl = torch.from_numpy(default_splitters(nb))
        return spl.to(device=self.device, dtype=torch.int32).contiguous()

    def _sort(self, records, valid, stage: SortStage, entry: _CacheEntry,
              i: int):
        """Range-partition shuffle (stage 1) + bucket-major regroup and one
        multi-segment sort (stage 2) — paper §4.2 / Fig 3.

        Returns ``(records, valid, dropped, sentinel_hits)``;
        ``sentinel_hits`` (real keys equal to the padding sentinel) is only
        counted when the resolved sort is the unstable bitonic network,
        else None.
        """
        world = self.ranks.world
        nb = (self.plan.num_buckets if self.plan is not None
              else stage.num_buckets or self.axis_size)
        spl = self._splitters(stage, nb)
        keys = torch.as_tensor(stage.key(records)).to(torch.int32)
        keys = keys.reshape(valid.shape).contiguous()
        bucket = torch.searchsorted(spl, keys, right=True, out_int32=True)
        records, valid, dropped = self._exchange(
            records, valid, bucket, nb, stage.capacity_factor, stage.chunks,
            entry, i)
        plan = entry.plans[i]

        # stage 2: bucket-major regroup (O(n) partition, stable) ...
        keys = torch.as_tensor(stage.key(records)).to(torch.int32)
        keys = keys.reshape(valid.shape)
        sentinel = kops.pad_sentinel(keys.dtype)
        skey = torch.where(valid, keys, sentinel).contiguous()
        r = skey.shape[1]
        bpd = plan.buckets_per_device
        seg_cap = (r if bpd == 1 else
                   min(r, int(r / bpd * stage.capacity_factor) + 1))
        algo = entry.algos.get(i)
        if algo is None:
            algo = kops.resolve_sort_algo(world * bpd, seg_cap, skey.dtype,
                                          self.sort_algo, kv=True,
                                          device=self.device)
            entry.algos[i] = algo
        sentinel_hits = None
        if not autotune.is_stable(algo):
            sentinel_hits = (valid & (keys == sentinel)).sum(dtype=torch.int32)
        local = (torch.searchsorted(spl, skey, right=True, out_int32=True)
                 - plan.device_index(self.ranks)[:, None] * bpd)
        seg_dest = torch.where(valid, local, bpd).to(torch.int32)
        leaves, treedef = tree_flatten(records)
        tiles, in_rng, _, seg_drop = kops.partition_pack(
            [skey] + leaves, seg_dest, bpd, seg_cap)
        dropped = dropped + self.ranks.psum(seg_drop, plan.pmean_axes())

        # ... then one multi-segment sort: ranks*bpd rows of seg_cap. Empty
        # slots carry the max-key sentinel so each segment's valid records
        # end in its prefix — where in_rng points.
        seg_keys = torch.where(in_rng, tiles[0], sentinel).reshape(
            world * bpd, seg_cap)
        pos = torch.arange(bpd * seg_cap, dtype=torch.int32,
                           device=self.device).reshape(1, bpd, seg_cap)
        pos = pos.expand(world, bpd, seg_cap).reshape(world * bpd, seg_cap)
        _, order = kops.sort_kv_segments(seg_keys, pos, algo=algo)
        m = bpd * seg_cap
        gidx = (order.reshape(world, m).to(torch.int64)
                + torch.arange(world, dtype=torch.int64,
                               device=self.device)[:, None] * m).reshape(-1)
        out = []
        for t in tiles[1:]:
            tail = tuple(t.shape[3:])
            out.append(t.reshape((world * m,) + tail).index_select(0, gidx)
                       .reshape((world, m) + tail))
        return (tree_unflatten(treedef, out), in_rng.reshape(world, m),
                dropped, sentinel_hits)


# -- host (Sector/SPE) executor ----------------------------------------------


class _Phase:
    """Consecutive record-wise stages, optionally ended by a shuffle/sort."""

    def __init__(self, stages: List[Any], terminator: Optional[Any]):
        self.stages = stages
        self.terminator = terminator


def _phases(df: Dataflow) -> List[_Phase]:
    out, cur = [], []
    for st in df.stages:
        if isinstance(st, (ShuffleStage, SortStage)):
            out.append(_Phase(cur, st))
            cur = []
        else:
            cur.append(st)
    out.append(_Phase(cur, None))
    return out


_STAGE_KIND = {MapStage: "map", ShuffleStage: "shuffle",
               ReduceStage: "reduce", SortStage: "sort"}

_scratch_counter = itertools.count()

#: the positive quiet NaN every float sort key's NaN becomes before K2
_CANONICAL_NAN_BITS = 0x7FC00000


class ExecutorFault(RuntimeError):
    """A failure of the host executor's own device steps — the stage-2
    sort (K2, its envelope) or the bucket split (K1) — not of the user's
    UDFs. The engine sees it as a UDF error of the segment, but
    :meth:`HostExecutor.run` raises it once the phase's engine run ends,
    so it is never reported as a data error and no partial result is
    returned."""


def _records_len(records) -> int:
    """n of a host records tree (each leaf ``(n, ...)``)."""
    return int(tree_flatten(records)[0][0].shape[0])


def _sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Float keys as ``np.argsort`` orders them: ``-0.0`` becomes ``+0.0``
    (numpy keeps equal zeros in input order, the radix sort's bit order
    puts ``-0.0`` first) and every NaN becomes the positive quiet NaN
    (numpy puts NaNs last, the bit order puts sign-bit NaNs first)."""
    if not keys.dtype.is_floating_point:
        return keys
    nan = torch.tensor(_CANONICAL_NAN_BITS, dtype=torch.int32).view(
        torch.float32).to(device=keys.device, dtype=keys.dtype)
    keys = torch.where(keys == 0, torch.zeros_like(keys), keys)
    return torch.where(torch.isnan(keys), nan, keys)


def stable_argsort(keys: torch.Tensor) -> torch.Tensor:
    """int64 order of ``np.argsort(keys, kind="stable")`` for ``(n,)``
    keys, on their device.

    int32, uint32 and float32 keys (floats canonicalised by
    :func:`_sort_keys`) go through K2, the stable LSD radix sort, with an
    ``arange`` payload; a row longer than its envelope raises with the
    reason. Keys of any other dtype (int64, float64, ...) take
    ``torch.sort(stable=True)``, chosen by dtype alone and counted in the
    ``host.sort_library`` metric; a kernel that fails to build or launch
    raises, it never falls back to this branch. K2 is called directly, not
    through ``kernels.ops.sort_kv_segments``, whose ``REPRO_KERNEL_FORCE``
    override could substitute the unstable bitonic network."""
    keys = _sort_keys(keys.reshape(-1))
    n = keys.shape[0]
    if keys.dtype not in (torch.int32, torch.uint32, torch.float32):
        REGISTRY.counter("host.sort_library").inc()
        return torch.sort(keys, stable=True).indices
    reason = radix_sort.radix_supported(n, 1)
    if reason is not None:
        raise ValueError(f"host stage-2 sort of {n} records: {reason}")
    pos = torch.arange(n, dtype=torch.int32, device=keys.device)
    _, order = radix_sort.sort_kv_segments_radix(keys.contiguous()[None],
                                                 pos[None])
    return order[0].to(torch.int64)


def _int32_keys(keys: torch.Tensor) -> torch.Tensor:
    """``np.asarray(keys).astype(np.int32)`` on the device: integers wrap,
    floats truncate toward zero, and a NaN or a float outside the int32
    range becomes INT32_MIN (numpy's cast on x86; the card's own cast
    would give 0 or saturate)."""
    keys = keys.reshape(-1)
    if not keys.dtype.is_floating_point:
        return keys.to(torch.int32)
    k = keys.to(torch.float64)
    bad = torch.isnan(k) | (k <= -2.0 ** 31 - 1) | (k >= 2.0 ** 31)
    k = torch.where(bad, torch.full_like(k, -2.0 ** 31), torch.trunc(k))
    return k.to(torch.int32)


def _searchsorted(splitters: Any, keys: torch.Tensor) -> torch.Tensor:
    """``np.searchsorted(splitters, keys, side="right")`` with int32
    keys: both sides are compared in int64, or in float64 when the
    splitters are floats, so that no value is rounded."""
    spl = torch.as_tensor(np.asarray(splitters)
                          if not isinstance(splitters, torch.Tensor)
                          else splitters).reshape(-1)
    wide = torch.float64 if spl.dtype.is_floating_point else torch.int64
    return torch.searchsorted(spl.to(device=keys.device, dtype=wide),
                              keys.to(wide), right=True)


def _bucket_major(packed: torch.Tensor, ids: torch.Tensor, nb: int):
    """Lay the packed rows out bucket after bucket, each bucket in arrival
    order, and drop ids outside ``[0, nb)`` — ``packed[ids == b]`` for
    each ``b``, one after another. K1 gives each row its stable rank among
    the earlier rows of its bucket and the counts; each row then goes to
    ``offset[bucket] + rank``. Returns the host ``(rows, nbytes)`` block
    and the ``(nb,)`` counts, from one device-to-host copy each."""
    n, width = packed.shape
    if n == 0:       # K1 launches nothing on an empty row
        return (packed.cpu().numpy(), np.zeros((nb,), np.int64))
    ids = ids.to(torch.int64)
    ok = (ids >= 0) & (ids < nb)
    ids = torch.where(ok, ids, -1).to(torch.int32)
    rank, counts = partition.partition_rank(ids, nb)
    counts_h = counts.cpu().numpy().astype(np.int64)
    total = int(counts_h.sum())
    offset = torch.cumsum(counts.to(torch.int64), dim=0) - counts
    # rows out of range all land in one extra row past the end, dropped
    dst = torch.where(ok, offset[ids.clamp(min=0).to(torch.int64)]
                      + rank.to(torch.int64), total)
    out = torch.empty((total + 1, width), dtype=packed.dtype,
                      device=packed.device)
    out.index_copy_(0, dst, packed)
    return out[:total].cpu().numpy(), counts_h


def _split_buckets(out) -> Dict[int, np.ndarray]:
    block, counts = out
    ends = np.cumsum(counts)
    return {b: block[ends[b] - counts[b]:ends[b]]
            for b in range(counts.shape[0])}


class HostExecutor:
    """Runs a :class:`Dataflow` on the Sector/SPE data plane.

    The pipeline splits into phases at shuffle/sort boundaries. Each phase is
    one :class:`repro_torch.sphere.engine.SphereProcess` stage: SPEs decode
    Sector segments through the source codec onto ``device`` (``cuda``
    unless the caller passes ``"cpu"``), run the phase's UDFs there, and
    route the (re-encoded) outputs either back to the client or into
    **bucket files** (the paper's §3.2 "bucket writers"), which are
    uploaded to Sector and become the next phase's input stream. Locality
    scheduling, SPE failure retry, and data-error reporting all come from
    the engine; validity masks never appear on this path because host
    buckets are variable-size (no capacity bound -> nothing is dropped by
    shuffles here).

    Per segment, on the device: a pending sort's stage 2 (the segment is
    one range partition; K2 via :func:`stable_argsort`), the phase's map
    and reduce stages, the valid filter, ``pack``, the bucket ids
    (``torch.searchsorted`` over the float64 :func:`host_splitters`, or
    the shuffle's ``by``), and the bucket split (K1 via
    :func:`_bucket_major`); then one copy of the rows and the counts to
    the host. A bucket count above K1's envelope raises before any work;
    a failure of K1 or K2 (a row past K2's envelope, a build or launch
    error) raises :class:`ExecutorFault` out of :meth:`run`.
    """

    def __init__(self, master, client, spes: Sequence[Any],
                 max_retries: int = 2, scratch_prefix: str = "/.dataflow",
                 daemon: Optional[Any] = None,
                 retry_policy: Optional[Any] = None,
                 device: Any = None):
        self.master = master
        self.client = client
        self.spes = list(spes)
        self.max_retries = max_retries
        #: optional :class:`repro_torch.core.retry.RetryPolicy` for the
        #: engine's segment re-pools (None keeps immediate zero-delay retries)
        self.retry_policy = retry_policy
        self.scratch_prefix = scratch_prefix
        #: optional :class:`repro_torch.sector.master.ReplicationDaemon`;
        #: when set, freshly uploaded bucket files are replicated before the
        #: next phase reads them — without it a mid-job slave death can take
        #: the only copy of a bucket with it (a DATA_ERROR, not silent loss)
        self.daemon = daemon
        self.device = resolve_device(device)

    def run(self, pipeline: Dataflow, file_paths: Sequence[str],
            trace: Optional[Any] = None) -> DataflowResult:
        """Execute ``pipeline`` over Sector files. ``pipeline.codec`` is
        required: it decodes the source records (record_bytes =
        ``codec.nbytes``).

        Recovery is always armed: segment reads that fail because every
        listed replica is gone trigger ``SectorClient.recover`` (master
        prunes stale locations, rediscovers survivors by §2.2 scan,
        re-replicates) and the segment is re-pooled per §3.5.2.

        ``trace``: a :class:`repro_torch.obs.trace.Tracer` — records
        ``host.run`` → ``phase[i]`` → per-segment spans (with retry /
        recovery sub-spans from the engine) and ``hop[i]:buckets`` spans
        for bucket materialization. Per-phase wall time is ALWAYS
        accounted in ``result.phase_times``, tracer or not."""
        from repro_torch.sphere.engine import SphereProcess

        if pipeline.codec is None:
            raise ValueError("HostExecutor needs Dataflow.source(codec=...) "
                             "to decode Sector records")
        phases = _phases(pipeline)
        for phase in phases:
            nb = self._num_buckets(phase.terminator)
            if phase.terminator is not None and not (
                    1 <= nb <= partition.MAX_NUM_DEST):
                raise ValueError(
                    f"{nb} buckets outside the bucket split's (K1's) "
                    f"envelope [1, {partition.MAX_NUM_DEST}]")
        tr = trace if trace is not None else NULL_TRACER
        codec = pipeline.codec
        paths = list(file_paths)
        scratch = f"{self.scratch_prefix}/run{next(_scratch_counter)}"
        errors: Dict[Any, str] = {}
        retries = 0
        dropped = 0
        recoveries = 0
        data_errors = 0
        pending_sort: Optional[SortStage] = None
        phase_times: List[Dict[str, Any]] = []

        with tr.span("host.run", pipeline=pipeline.describe(),
                     files=len(paths)) as root:
            for pi, phase in enumerate(phases):
                t0 = time.monotonic()
                term = phase.terminator
                term_kind = ("output" if term is None else
                             _STAGE_KIND[type(term)])
                with tr.span(f"phase[{pi}]", paths=len(paths),
                             terminator=term_kind) as psp:
                    proc = SphereProcess(self.master, self.client.session_id,
                                         self.spes,
                                         max_retries=self.max_retries,
                                         retry_policy=self.retry_policy,
                                         device=self.device)
                    holder: Dict[str, Any] = {"codec": None, "dropped": 0,
                                              "fault": None}
                    udf = self._phase_udf(phase, pending_sort, holder)
                    nb = self._num_buckets(term)
                    if term is not None:
                        bucket_fn = _split_buckets
                    else:
                        bucket_fn, nb = None, 0
                    # after a shuffle, a bucket file must stay one segment
                    # (one reduce group) — force whole-file segmentation
                    seg_kw = ({} if pi == 0 else
                              {"s_min": 1 << 40, "s_max": 1 << 40})
                    res = proc.run(paths, udf, record_bytes=codec.nbytes,
                                   codec=codec, bucket_fn=bucket_fn,
                                   num_buckets=nb,
                                   recover=self.client.recover,
                                   trace=trace, **seg_kw)
                    if holder["fault"] is not None:
                        raise holder["fault"]
                    retries += res.retries
                    recoveries += res.recoveries
                    data_errors += res.data_errors
                    dropped += holder["dropped"]
                    errors.update({(pi, k): v for k, v in res.errors.items()})
                    out_codec = holder["codec"] or codec
                    psp.set(segments=res.segments_processed,
                            retries=res.retries, recoveries=res.recoveries,
                            data_errors=res.data_errors)
                    materialize_s = 0.0
                    if term is not None:
                        # materialize bucket files as the next phase's input
                        m0 = time.monotonic()
                        with tr.span(f"hop[{pi}]:buckets", buckets=nb):
                            prefix = f"{scratch}/s{pi}"
                            self.client.upload_dataset(
                                prefix,
                                [np.ascontiguousarray(res.outputs[b])
                                 .tobytes() for b in range(nb)])
                            paths = [f"{prefix}.{b:05d}" for b in range(nb)]
                            if self.daemon is not None:
                                # replicate fresh bucket files before
                                # anything can eat them
                                self.daemon.run_until_stable()
                        materialize_s = time.monotonic() - m0
                    elapsed = time.monotonic() - t0
                    phase_times.append({
                        "phase": pi, "terminator": term_kind,
                        "seconds": elapsed, "engine_s": res.elapsed_s,
                        "materialize_s": materialize_s,
                        "segments": res.segments_processed,
                        "retries": res.retries,
                        "recoveries": res.recoveries,
                        "data_errors": res.data_errors,
                    })
                    REGISTRY.histogram("host.phase_seconds").observe(elapsed)
                    if term is None:
                        REGISTRY.counter("host.dropped").inc(dropped)
                        root.set(phases=len(phase_times), dropped=dropped)
                        parts = [res.outputs[i] for i in sorted(res.outputs)]
                        packed = (torch.cat(parts, dim=0) if parts
                                  else torch.zeros((0, out_codec.nbytes),
                                                   dtype=torch.uint8,
                                                   device=self.device))
                        records = out_codec.unpack(packed)
                        n = _records_len(records)
                        return DataflowResult(
                            records=records,
                            valid=torch.ones((n,), dtype=torch.bool,
                                             device=self.device),
                            dropped=torch.tensor(dropped, dtype=torch.int32,
                                                 device=self.device),
                            errors=errors, retries=retries,
                            recoveries=recoveries, data_errors=data_errors,
                            trace=trace, phase_times=phase_times)
                    codec = out_codec
                    pending_sort = (term if isinstance(term, SortStage)
                                    else None)
        raise AssertionError("unreachable: final phase returns")

    # -- phase lowering -------------------------------------------------------
    def _num_buckets(self, term) -> int:
        if term is None:
            return 0
        if term.num_buckets is not None:
            return term.num_buckets
        if isinstance(term, SortStage) and term.splitters is not None:
            return int(np.asarray(term.splitters).shape[0]) + 1
        return len(self.spes)

    def _phase_udf(self, phase: _Phase, pending_sort: Optional[SortStage],
                   holder: Dict[str, Any]) -> Callable:
        """Build the (decoded records) -> packed rows UDF one SPE runs.

        The output record schema is only known once a segment has been
        processed; it is stashed in ``holder`` so the executor can decode the
        bucket files / final outputs (every segment must agree). A phase
        that ends in a shuffle or sort returns the host block of its rows in
        bucket order and the per-bucket counts; the output phase returns the
        packed rows on the device. A failure of the executor's own kernel
        steps is kept in ``holder["fault"]`` (for :meth:`run` to raise) and
        fails every later segment of the phase at once."""
        term = phase.terminator
        nb = self._num_buckets(term)
        spl = None
        if isinstance(term, SortStage):
            spl = (term.splitters if term.splitters is not None
                   else host_splitters(nb))
        dev = self.device

        def own(step, *args):
            try:
                return step(*args)
            except Exception as e:
                fault = ExecutorFault(f"{step.__name__}: {e}")
                holder["fault"] = fault
                raise fault from e

        def udf(records):
            if holder["fault"] is not None:
                raise holder["fault"]
            if pending_sort is not None and _records_len(records) > 0:
                # stage 2 of a sort: this segment IS one range partition
                order = own(stable_argsort, torch.as_tensor(
                    pending_sort.key(records)).to(dev))
                records = tree_map(lambda a: a[order], records)
            valid = torch.ones((_records_len(records),), dtype=torch.bool,
                               device=dev)
            for stage in phase.stages:
                if isinstance(stage, MapStage):
                    records = stage.fn(records)
                    if _records_len(records) != valid.shape[0]:
                        valid = torch.ones((_records_len(records),),
                                           dtype=torch.bool, device=dev)
                elif isinstance(stage, ReduceStage):
                    records, valid, rd = _split_reduce_out(
                        stage.fn(records, valid))
                    valid = torch.as_tensor(valid).to(dev).reshape(-1)
                    if rd is not None:
                        holder["dropped"] += int(rd)
                else:
                    raise TypeError(f"unexpected mid-phase stage {stage!r}")
            records = tree_map(lambda a: a[valid], records)
            codec = RecordCodec.from_example(records)
            if holder["codec"] is None:
                holder["codec"] = codec
            elif holder["codec"] != codec:
                raise ValueError("UDF output schema differs across segments: "
                                 f"{holder['codec']} vs {codec}")
            packed = codec.pack(records)
            if term is None:
                return packed
            if isinstance(term, SortStage):
                ids = _searchsorted(spl, _int32_keys(
                    torch.as_tensor(term.key(records)).to(dev)))
            else:
                ids = torch.as_tensor(term.by(records)).to(dev).reshape(-1)
            return own(_bucket_major, packed, ids, nb)

        return udf
