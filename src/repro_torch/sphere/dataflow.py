"""Unified Sphere dataflow on stacked ranks: the SPMD executor.

Port of ``repro/sphere/dataflow.py`` (the pipeline description and
``SPMDExecutor``; the host executor, chaos/resume, streaming carry and
per-stage tracing are not ported yet). A :class:`Dataflow` is a
declarative chain of stages over *records* — any fixed-shape dict / tuple
/ list tree of tensors sharing leading record axes::

    df = Dataflow.source().sort(key=lambda r: r["key"], splitters=...)
    res = SPMDExecutor(Ranks(8)).run(df, records)        # paper §4.2
    grid = Ranks(shape=(2, 4), axes=("dc", "node"))
    res = SPMDExecutor(grid).run(df, records)            # wide area, §2.2

:class:`SPMDExecutor` runs every stage once over all ranks of a
:class:`repro_torch.comm.Ranks` (records carry a leading rank axis):
maps and reduces inline per rank, shuffles as capacity-bounded
exchanges through :class:`repro_torch.core.shuffle.ShufflePlan` (one
``all_to_all`` over a flat axis, two over a ``(dc, node)`` grid), and a
sort stage as the two-stage terasort — a range-partition shuffle, then a
bucket-major regroup (kernel K1) and one multi-segment sort (kernel K3 or
K2, or the ``torch.sort`` oracle).

UDF contracts are the JAX package's: ``map(fn)`` maps records to records
(padding-oblivious); ``shuffle(by)`` gives ``(ranks, n)`` bucket ids,
negative meaning "emit nothing"; ``reduce(fn)`` takes ``(records,
valid)`` of one rank group and returns ``(records, valid)`` or ``(records,
valid, dropped)`` — here over all ranks at once, each leaf leading with
the rank axis (``dropped`` a scalar or one count per rank, summed).
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict, namedtuple
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.comm import Ranks
from repro_torch.core.records import (RecordCodec, tree_flatten, tree_map,
                                      tree_unflatten)
from repro_torch.core.shuffle import ShufflePlan, record_hops
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as kops
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
    """records: output tree, each leaf ``(ranks, slots, ...)`` — mask with
    ``valid`` ``(ranks, slots)``. dropped: ``()`` int32 records lost to
    capacity bounds plus drops reported by reduce UDFs. trace: the tracer
    the run recorded into (None when untraced)."""

    records: Any
    valid: torch.Tensor
    dropped: torch.Tensor
    trace: Optional[Any] = None


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
    """Equal-width int32 range splitters, computed in float32 the way
    ``jnp.linspace(key_min, key_max, nb + 1)[1:-1].astype(int32)`` does
    (``start * (1 - t) + stop * t``, ``t = i / nb``). Equal to the JAX
    package's for every power-of-two bucket count; XLA's float32 division
    may differ by one ulp elsewhere. float64 would give other splitters."""
    div = np.float32(num_buckets)
    t = (np.arange(num_buckets, dtype=np.float32) / div).astype(np.float32)
    start, stop = np.float32(key_min), np.float32(key_max)
    edges = (start * (np.float32(1) - t) + stop * t).astype(np.float32)
    return edges[1:].astype(np.int32)


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
