"""Streaming Sphere: continuous micro-batch dataflow + multi-tenant admission.

Port of ``repro/sphere/streaming.py``. The paper's Sphere is a *stream*
processor — "Sphere takes streams as inputs and produces streams as
outputs" (§3.2). This module turns the same declarative stage graph into a
long-lived serving loop:

- :class:`StreamExecutor` runs a ``Dataflow.stream_source()`` pipeline
  continuously over fixed-shape **micro-batches** on an
  :class:`~repro_torch.sphere.dataflow.SPMDExecutor` over stacked ranks.
  Every micro-batch has the same shapes, so the executor's plan cache
  misses once and hits afterwards (``cache_info()``). Pipelines whose last
  reduce is schema-preserving keep **bounded cross-batch carry state**:
  the reduce output is compacted into a fixed-capacity per-rank buffer and
  merged back into the next batch's reduce input. Carry never crosses
  ranks: the deterministic shuffle routes a key to the same rank every
  batch.

- :class:`TenantQueue` is the admission layer in front of the executor,
  copied from the reference (framework-free): strict **priority classes**,
  **weighted fair share** inside a class by deficit round-robin,
  per-request **deadlines** with timeout/requeue (abandoned after
  ``max_requeues``, the §3.5.2 rule), and **bounded queues**
  (:class:`QueueFull`). Delivery is exactly-once.

Carry-state contract (what a streaming ``reduce`` UDF must satisfy):
schema-preserving (its output is fed back in), merge-idempotent
(``fn(out ++ new) == fn(all)`` up to row order) and bounded (at most the
carry capacity of valid rows per rank survive a batch; overflow is dropped
and counted). The final snapshot of a carried stream equals the one-shot
batch run over everything admitted.

Faults at batch boundaries (:class:`~repro_torch.sphere.chaos.ChaosSchedule`):
``lose_batch`` requeues the in-flight tickets; ``lose_device`` re-forms a
smaller grid of ranks on the same device and re-stacks the carry from the
boundary's :class:`~repro_torch.sphere.chaos.StreamCheckpoint` (one more
cache miss); Sector faults hit the deployment wired in by
:meth:`StreamExecutor.attach_sector`. A failure of the pipeline itself — a
kernel that fails to build or launch — ends :meth:`StreamExecutor.step`
with the error; only injected faults requeue a batch.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.records import (RecordCodec, tree_flatten, tree_map,
                                      tree_unflatten)
from repro_torch.core.retry import RetryPolicy
from repro_torch.kernels import bitonic_sort, bucket_hist, partition, radix_sort
from repro_torch.obs.metrics import MS_BUCKETS, REGISTRY
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sphere.chaos import (SPMD_KINDS, STREAM_KINDS, ChaosSchedule,
                                      StreamCheckpoint)
from repro_torch.sphere.dataflow import (Dataflow, MapStage, ReduceStage,
                                         SPMDExecutor, _last_reduce_index,
                                         _leading, _pinned_buckets,
                                         _split_reduce_out, _valid_rows)
from repro_torch.sphere.scheduler import DeadlineHeap, SegStatus

_KERNELS = (partition.KERNEL, bitonic_sort.KERNEL, radix_sort.KERNEL,
            bucket_hist.KERNEL)


def _launches() -> Dict[str, int]:
    return {k.name: k.launches for k in _KERNELS}


class QueueFull(RuntimeError):
    """Backpressure: the tenant's bounded admission queue is at capacity."""

    def __init__(self, tenant: str, depth: int):
        super().__init__(f"tenant {tenant!r} queue full ({depth} pending); "
                         f"retry after completions drain it")
        self.tenant = tenant
        self.depth = depth


@dataclasses.dataclass
class Ticket:
    """One admitted request. Status reuses the scheduler's segment states:
    PENDING = queued, RUNNING = in a dispatched micro-batch, DONE =
    delivered (exactly once), DATA_ERROR = abandoned after max requeues."""

    req_id: int
    tenant: str
    payload: Any
    cost: int                          # admission-budget units (records)
    admitted_at: float
    timeout: Optional[float] = None
    deadline: Optional[float] = None
    status: SegStatus = SegStatus.PENDING
    attempts: int = 0                  # times dispatched into a batch
    requeues: int = 0                  # timeout / failure re-admissions
    completed_at: Optional[float] = None
    #: earliest re-dispatch time set by the queue's RetryPolicy on requeue;
    #: the ticket keeps its head seniority but is not served before this
    not_before: Optional[float] = None


@dataclasses.dataclass
class TenantState:
    name: str
    weight: float = 1.0
    priority: int = 0                  # lower = more urgent (strict classes)
    capacity: int = 64                 # max queued tickets (backpressure)
    deficit: float = 0.0               # DRR credit, persists across rounds
    queue: "deque[Ticket]" = dataclasses.field(default_factory=deque)
    # -- stats ---------------------------------------------------------------
    admitted: int = 0
    rejected: int = 0
    delivered: int = 0
    records_served: int = 0
    timeouts: int = 0
    requeues: int = 0
    failed: int = 0
    latencies: "deque[float]" = dataclasses.field(
        default_factory=lambda: deque(maxlen=4096))


def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


class TenantQueue:
    """Multi-tenant admission queue: strict priority classes, weighted
    deficit-round-robin fair share within a class, deadlines with
    timeout/requeue, bounded per-tenant queues (see module docstring).

    All methods take an explicit ``now`` (any monotonic unit — seconds,
    engine steps, virtual time); omit it to use ``time.monotonic()``.
    """

    def __init__(self, quantum: float = 64.0, timeout: Optional[float] = None,
                 max_requeues: int = 3, capacity: int = 64,
                 retry_policy: Optional[RetryPolicy] = None):
        #: DRR credit added per round per unit weight. Any value > 0 is
        #: fair in the long run; >= the typical request cost keeps each
        #: acquire() pass O(tenants).
        self.quantum = quantum
        self.timeout = timeout          # default per-request deadline
        self.max_requeues = max_requeues
        self.capacity = capacity
        #: when set, a requeued ticket backs off (``not_before``) per the
        #: policy before it can be dispatched again; the deadline is pushed
        #: past the backoff so the delay never eats the ticket's timeout
        self.retry_policy = retry_policy
        self._tenants: "Dict[str, TenantState]" = {}
        self._deadlines = DeadlineHeap()
        self._next_id = 0
        self._rr_offset = 0             # rotates DRR start tenant per acquire

    @staticmethod
    def _now(now: Optional[float]) -> float:
        return time.monotonic() if now is None else now

    def register(self, tenant: str, weight: float = 1.0, priority: int = 0,
                 capacity: Optional[int] = None) -> TenantState:
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = TenantState(
                tenant, weight=weight, priority=priority,
                capacity=self.capacity if capacity is None else capacity)
        else:
            st.weight, st.priority = weight, priority
            if capacity is not None:
                st.capacity = capacity
        return st

    # -- admission -----------------------------------------------------------
    def admit(self, tenant: str, payload: Any, cost: int = 1,
              timeout: Optional[float] = -1.0,
              now: Optional[float] = None) -> Ticket:
        """Admit one request; raises :class:`QueueFull` at capacity.
        ``timeout`` overrides the queue default (None disables the
        deadline; the -1.0 sentinel means "use the default")."""
        now = self._now(now)
        st = self._tenants.get(tenant) or self.register(tenant)
        if len(st.queue) >= st.capacity:
            st.rejected += 1
            REGISTRY.counter("tenant.rejected", tenant=tenant).inc()
            raise QueueFull(tenant, len(st.queue))
        if timeout == -1.0:
            timeout = self.timeout
        tk = Ticket(req_id=self._next_id, tenant=tenant, payload=payload,
                    cost=int(cost), admitted_at=now, timeout=timeout)
        self._next_id += 1
        if timeout is not None:
            tk.deadline = now + timeout
            self._deadlines.push(tk.deadline, tk)
        st.queue.append(tk)
        st.admitted += 1
        REGISTRY.counter("tenant.admitted", tenant=tenant).inc()
        return tk

    # -- dispatch: strict priority + deficit round-robin ---------------------
    def acquire(self, budget: int, now: Optional[float] = None
                ) -> List[Ticket]:
        """Pull up to ``budget`` cost units of requests for one micro-batch.

        Priority classes are strict and non-bypassing: a class is only
        served once every more-urgent class is drained, and if its head
        request no longer fits the remaining budget, lower classes do NOT
        fill the gap (the leftover budget is padding — fairness beats batch
        packing). Within a class, deficit round-robin: each round every
        backlogged tenant earns ``weight * quantum`` credit and serves
        requests while credit and budget allow, so served cost converges to
        the weight ratio whatever the request sizes.

        A head ticket still inside its retry backoff window (``not_before``
        in the future) makes its tenant temporarily non-backlogged: the
        slot passes to peers (or lower classes) instead of busy-waiting on
        a ticket that chose to sit out."""
        now = self._now(now)
        self.expire(now)

        def ready(t: TenantState) -> bool:
            return bool(t.queue) and (t.queue[0].not_before is None
                                      or t.queue[0].not_before <= now)

        taken: List[Ticket] = []
        remaining = budget
        self._rr_offset += 1
        classes = sorted({t.priority for t in self._tenants.values()
                          if ready(t)})
        for prio in classes:
            cls = [t for t in self._tenants.values() if t.priority == prio]
            off = self._rr_offset % len(cls)
            cls = cls[off:] + cls[:off]
            while remaining > 0:
                backlog = [t for t in cls if ready(t)]
                if not backlog:
                    break
                if min(t.queue[0].cost for t in backlog) > remaining:
                    remaining = 0       # strict: no bypass by lower classes
                    break
                for t in backlog:
                    if not ready(t):
                        if not t.queue:
                            t.deficit = 0.0
                        continue
                    t.deficit += t.weight * self.quantum
                    while (ready(t) and t.queue[0].cost <= t.deficit
                           and t.queue[0].cost <= remaining):
                        tk = t.queue.popleft()
                        tk.status = SegStatus.RUNNING
                        tk.attempts += 1
                        t.deficit -= tk.cost
                        remaining -= tk.cost
                        taken.append(tk)
                        if remaining <= 0:
                            break
                    if not t.queue:
                        t.deficit = 0.0  # classic DRR: no credit hoarding
                    if remaining <= 0:
                        break
            if remaining <= 0:
                break
        return taken

    # -- completion / failure / expiry ---------------------------------------
    def complete(self, ticket: Ticket, now: Optional[float] = None) -> bool:
        """Mark delivered. Returns False (and changes nothing) if the ticket
        already completed or failed — the exactly-once guard: late
        completions of a requeued copy are suppressed, and a still-queued
        duplicate is withdrawn when its twin completes first."""
        now = self._now(now)
        if ticket.status in (SegStatus.DONE, SegStatus.DATA_ERROR):
            return False
        if ticket.status == SegStatus.PENDING:
            # completed by an earlier dispatch while its requeued copy
            # waited — withdraw the copy so it cannot deliver again
            try:
                self._tenants[ticket.tenant].queue.remove(ticket)
            except ValueError:
                pass
        ticket.status = SegStatus.DONE
        ticket.completed_at = now
        st = self._tenants[ticket.tenant]
        st.delivered += 1
        st.records_served += ticket.cost
        st.latencies.append(now - ticket.admitted_at)
        REGISTRY.counter("tenant.delivered", tenant=ticket.tenant).inc()
        REGISTRY.histogram("tenant.latency", tenant=ticket.tenant).observe(
            now - ticket.admitted_at)
        return True

    def requeue(self, ticket: Ticket, now: Optional[float] = None) -> bool:
        """Put a dispatched-but-unfinished (or timed-out) ticket back at the
        *head* of its tenant's queue with a fresh deadline — it keeps its
        seniority (a blown deadline escalates, it must not start over behind
        the backlog that starved it, or it would time out forever). After
        ``max_requeues`` the ticket is abandoned and reported (status
        DATA_ERROR) — the paper's §3.5.2 bounded-retry rule. Returns True
        iff the ticket is queued again."""
        now = self._now(now)
        if ticket.status in (SegStatus.DONE, SegStatus.DATA_ERROR):
            return False
        st = self._tenants[ticket.tenant]
        if ticket.status == SegStatus.PENDING:
            try:
                st.queue.remove(ticket)
            except ValueError:
                pass
        ticket.requeues += 1
        st.requeues += 1
        REGISTRY.counter("tenant.requeues", tenant=ticket.tenant).inc()
        if ticket.requeues > self.max_requeues:
            ticket.status = SegStatus.DATA_ERROR
            st.failed += 1
            REGISTRY.counter("tenant.failed", tenant=ticket.tenant).inc()
            return False
        ticket.status = SegStatus.PENDING
        delay = 0.0
        if self.retry_policy is not None:
            # keyed by req_id so concurrent requeuers de-synchronize while
            # a given ticket replays the same deterministic backoff ladder
            delay = self.retry_policy.delay(max(0, ticket.requeues - 1),
                                            key=ticket.req_id)
            ticket.not_before = now + delay
            REGISTRY.histogram("tenant.backoff_ms", bounds=MS_BUCKETS,
                               tenant=ticket.tenant).observe(delay * 1e3)
        if ticket.timeout is not None:
            ticket.deadline = now + delay + ticket.timeout
            self._deadlines.push(ticket.deadline, ticket)
        st.queue.appendleft(ticket)
        return True

    def expire(self, now: Optional[float] = None) -> List[Ticket]:
        """Requeue every *queued* ticket whose deadline has passed (fresh
        deadline, head position, ``timeouts`` counted; abandoned once
        ``max_requeues`` is exhausted). RUNNING tickets are left alone —
        a lost in-flight batch is the dispatcher's to report via
        :meth:`requeue`. Returns the tickets that were requeued."""
        now = self._now(now)
        requeued = []
        for deadline, tk in self._deadlines.pop_due(now):
            if tk.status != SegStatus.PENDING or tk.deadline != deadline:
                continue                # stale entry (refreshed or moved on)
            self._tenants[tk.tenant].timeouts += 1
            REGISTRY.counter("tenant.timeouts", tenant=tk.tenant).inc()
            if self.requeue(tk, now=now):
                requeued.append(tk)
        return requeued

    # -- introspection -------------------------------------------------------
    def depth(self, tenant: Optional[str] = None) -> int:
        if tenant is not None:
            st = self._tenants.get(tenant)
            return len(st.queue) if st else 0
        return sum(len(t.queue) for t in self._tenants.values())

    def pending(self) -> int:
        return self.depth()

    def pending_items(self) -> List[Ticket]:
        return [tk for t in self._tenants.values() for tk in t.queue]

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant serving stats: depth, throughput counters, latency
        percentiles (in whatever ``now`` unit the caller used)."""
        out = {}
        for name, t in self._tenants.items():
            out[name] = {
                "weight": t.weight, "priority": t.priority,
                "queue_depth": len(t.queue), "admitted": t.admitted,
                "delivered": t.delivered, "rejected": t.rejected,
                "records_served": t.records_served,
                "timeouts": t.timeouts, "requeues": t.requeues,
                "failed": t.failed,
                "latency_p50": _percentile(t.latencies, 50),
                "latency_p99": _percentile(t.latencies, 99),
            }
        return out


# -- streaming executor ------------------------------------------------------


@dataclasses.dataclass
class StreamBatch:
    """One micro-batch's emitted output (a slice of the output stream):
    ``records`` leaves and ``valid`` are ``(ranks, slots, ...)`` tensors."""

    step: int
    records: Any
    valid: Any
    dropped: int
    delivered: List[Ticket]
    requeued: List[Ticket] = dataclasses.field(default_factory=list)

    def valid_records(self) -> Any:
        return _valid_rows(self.records, self.valid)


class StreamExecutor:
    """Run one ``Dataflow.stream_source()`` pipeline continuously over
    micro-batches fed by a :class:`TenantQueue` (see module docstring).

    ``micro_batch`` is the global records-per-batch (divisible by the
    executor's rank count); short batches are padded with invalid rows so
    every batch has the same shapes, and the rows go rank-major into
    ``(ranks, micro_batch / ranks)`` tensors — the row order of the JAX
    package's ``P("data")`` sharding — in one copy per leaf to the
    executor's device. ``carry_capacity`` > 0 (per-rank rows) enables
    cross-batch carry for pipelines whose last reduce is
    schema-preserving; 0 disables carry (each batch is independent).

    Sorted stages run through ``inner``'s stage-2 segment sort and so
    inherit its ``sort_algo`` / autotuner choice.

    ``chaos``: a :class:`~repro_torch.sphere.chaos.ChaosSchedule` (or a
    single batch-armed :class:`~repro_torch.sphere.chaos.FaultPlan`) of
    faults fired at micro-batch boundaries: ``lose_batch`` drops the
    in-flight batch (tickets requeue), ``lose_device`` additionally
    re-forms a smaller grid of ranks and re-stacks the carry from the
    boundary's :class:`StreamCheckpoint` (one more cache miss), and host
    faults hit the Sector deployment wired in via :meth:`attach_sector`.
    Every fault and recovery appends to the schedule's shared audit log.
    """

    def __init__(self, inner: SPMDExecutor, pipeline: Dataflow,
                 micro_batch: int, carry_capacity: int = 0,
                 queue: Optional[TenantQueue] = None,
                 clock: Optional[Callable[[], float]] = None,
                 trace: Optional[Any] = None,
                 chaos: Optional[Any] = None):
        if not pipeline.stream:
            raise ValueError(
                "StreamExecutor needs a Dataflow.stream_source() pipeline "
                "(got a one-shot source; batch executors run those)")
        if micro_batch % inner.axis_size != 0:
            raise ValueError(f"micro_batch={micro_batch} must be divisible "
                             f"by the mesh axis size {inner.axis_size}")
        if carry_capacity:
            _last_reduce_index(pipeline)   # raises if there is no reduce
        if chaos is not None and not hasattr(chaos, "due_at_batch"):
            # a bare FaultPlan rides as a one-entry schedule; seed=0 keeps
            # the plan's own seed untouched ((0*P+0)*P + s == s)
            chaos = ChaosSchedule([chaos], seed=0)
        self.inner = inner
        self.pipeline = pipeline
        self.micro_batch = micro_batch
        self.carry_capacity = carry_capacity
        self.queue = queue if queue is not None else TenantQueue()
        self.trace = trace if trace is not None else NULL_TRACER
        self.chaos: Optional[ChaosSchedule] = chaos
        self._clock = clock or time.monotonic
        self._carry: Optional[Tuple[Any, Any]] = None
        self._codec: Optional[RecordCodec] = None
        self._steps = 0
        self._records_in = 0
        self._batch_failures = 0
        self._run_seconds = 0.0
        self._recoveries = 0
        #: kernel launches of the carry's schema probe (:meth:`_init_carry`),
        #: kept apart from the micro-batches' own
        self.init_launches: Dict[str, int] = {}
        #: cache_info() of grids retired by mid-stream recovery — stats()
        #: sums them with the live executor so the "one more miss per
        #: recovery" invariant stays checkable after the grid shrank
        self._retired_cache: List[Any] = []
        self._checkpoint: Optional[StreamCheckpoint] = None
        self._sector: Optional[Dict[str, Any]] = None
        #: the carry buffer's GLOBAL row capacity is frozen at construction
        #: (not re-derived from the current grid) so a stream that loses
        #: ranks before its first carried batch still allocates the same
        #: global state as the fault-free run
        self._carry_cap_total = carry_capacity * inner.axis_size

    # -- submission ----------------------------------------------------------
    def submit(self, records: Any, tenant: str = "default",
               timeout: Optional[float] = -1.0,
               now: Optional[float] = None) -> Ticket:
        """Admit one request: a record tree of numpy arrays (its leading
        dim is the cost). All requests must share one schema; a request
        larger than a micro-batch is rejected outright (it could never be
        dispatched)."""
        records = tree_map(np.asarray, records)
        codec = RecordCodec.from_example(records)
        if self._codec is None:
            self._codec = codec
        elif self._codec != codec:
            raise ValueError(f"request schema {codec} differs from the "
                             f"stream's {self._codec}")
        cost = int(tree_flatten(records)[0][0].shape[0])
        if cost == 0 or cost > self.micro_batch:
            raise ValueError(f"request of {cost} records cannot ride a "
                             f"{self.micro_batch}-record micro-batch")
        return self.queue.admit(tenant, records, cost=cost, timeout=timeout,
                                now=self._now(now))

    def _now(self, now: Optional[float]) -> float:
        return self._clock() if now is None else now

    # -- the continuous loop -------------------------------------------------
    def step(self, now: Optional[float] = None) -> Optional[StreamBatch]:
        """One micro-batch: expire deadlines, admit a fair batch, seal a
        :class:`~repro_torch.sphere.chaos.StreamCheckpoint` (carry +
        in-flight ticket ids), run Sector upkeep and any due chaos faults,
        run the pipeline once, deliver. Returns None on an idle tick; a
        batch lost to an injected fault comes back with its requeued
        tickets and no records."""
        now = self._now(now)
        self.queue.expire(now)
        tickets = self.queue.acquire(self.micro_batch, now=now)
        if not tickets:
            return None
        tr = self.trace
        ckpt = StreamCheckpoint.seal(self._steps, tickets, self._carry)
        self._checkpoint = ckpt
        if self._sector is not None:
            self._sector_boundary(ckpt, now, tr)
        if self.chaos is not None:
            failed = self._fire_chaos(tickets, ckpt, now, tr)
            if failed is not None:
                return failed
        batch, valid, n = self._assemble(tickets)
        if self.carry_capacity and self._carry is None:
            self._carry = self._init_carry(batch, valid)
        with tr.span(f"stream.batch[{self._steps}]", records=n,
                     tenants=sorted({t.tenant for t in tickets}),
                     admission_wait_max=max(now - t.admitted_at
                                            for t in tickets)) as bsp:
            t0 = time.monotonic()
            res = self.inner.run(self.pipeline, batch, valid=valid,
                                 carry=self._carry,
                                 trace=tr if tr.enabled else None)
            dropped = int(res.dropped)      # waits for the device
            self._run_seconds += time.monotonic() - t0
            if self.carry_capacity:
                self._carry = res.carry
            if tr.enabled:
                carry_rows = (int(self._carry[1].sum())
                              if self._carry is not None else 0)
                bsp.set(dropped=dropped, carry_rows=carry_rows)
        self._steps += 1
        self._records_in += n
        REGISTRY.counter("stream.batches").inc()
        REGISTRY.counter("stream.records").inc(n)
        delivered = [t for t in tickets if self.queue.complete(t, now=now)]
        return StreamBatch(step=self._steps, records=res.records,
                           valid=res.valid, dropped=dropped,
                           delivered=delivered)

    def drain(self, max_steps: int = 10_000) -> List[StreamBatch]:
        """Step until the admission queue is empty (or ``max_steps``)."""
        out = []
        while self.queue.pending() and max_steps > 0:
            b = self.step()
            if b is not None:
                out.append(b)
            max_steps -= 1
        return out

    # -- durability + chaos --------------------------------------------------
    def attach_sector(self, master: Any, client: Any, daemon: Any = None,
                      detector: Any = None, prefix: str = "/stream/ckpt",
                      retain: int = 8) -> None:
        """Make the stream durable against Sector faults: at every
        micro-batch boundary the sealed :class:`StreamCheckpoint` is
        uploaded to a *versioned* path (``{prefix}.{step:06d}``; the last
        ``retain`` are kept), the
        :class:`~repro_torch.sector.master.FailureDetector` ticks on the
        stream clock, newly-down slaves trigger ``client.recover`` over the
        retained checkpoints (counted in ``stats()["recoveries"]``), and
        finally the :class:`~repro_torch.sector.master.ReplicationDaemon`
        runs its lazy re-replication pass. Host-level chaos faults
        (``kill_slave``, ``rejoin_slave``, ``drop_bucket``) in the schedule
        fire against this deployment and target the retained checkpoint
        paths."""
        self._sector = {"master": master, "client": client, "daemon": daemon,
                        "detector": detector, "prefix": prefix,
                        "retain": max(1, int(retain)), "paths": []}

    def _sector_boundary(self, ckpt: StreamCheckpoint, now: float,
                         tr: Any) -> None:
        s = self._sector
        client, master = s["client"], s["master"]
        path = f"{s['prefix']}.{ckpt.step:06d}"
        client.upload(path, ckpt.to_bytes())
        s["paths"].append(path)
        while len(s["paths"]) > s["retain"]:
            old = s["paths"].pop(0)
            try:
                client.delete(old)
            except (IOError, OSError, KeyError):
                pass                    # retention GC is best-effort
        det = s["detector"]
        if det is not None:
            newly_down = det.tick(now)
            if newly_down:
                before = master.stats["recoveries"]
                for p in list(s["paths"]):
                    try:
                        client.recover(p)
                    except (IOError, OSError):
                        pass            # daemon will keep trying
                if master.stats["recoveries"] > before:
                    self._recoveries += 1
                    REGISTRY.counter("stream.recoveries").inc()
                    tr.event("sector_recover", step=self._steps,
                             slaves=str(newly_down),
                             checkpoints=len(s["paths"]))
                    if self.chaos is not None:
                        self.chaos.events.append(
                            f"batch {self._steps}: slaves {newly_down} "
                            f"declared down; re-replicated "
                            f"{len(s['paths'])} stream checkpoints")
        if s["daemon"] is not None:
            s["daemon"].tick()

    def _fire_chaos(self, tickets: Sequence[Ticket],
                    ckpt: StreamCheckpoint, now: float,
                    tr: Any) -> Optional[StreamBatch]:
        """Fire every schedule entry armed at this batch. Device loss
        re-forms the mesh *and* abandons the in-flight batch (its tickets
        requeue with full exactly-once protection); ``lose_batch`` only
        abandons; host faults hit the attached Sector deployment and the
        stream keeps running on top of it."""
        failed: Optional[StreamBatch] = None
        sector = self._sector or {}
        for f in self.chaos.due_at_batch(self._steps):
            if f.kind in SPMD_KINDS:
                lost = f.fire_stream(self._steps,
                                     num_devices=self.inner.axis_size)
                self._recover_mesh(int(lost), ckpt, tr)
                if failed is None:
                    failed = self._abandon_batch(tickets, now, tr,
                                                 reason="lose_device")
            elif f.kind in STREAM_KINDS:
                f.fire_stream(self._steps)
                if failed is None:
                    failed = self._abandon_batch(tickets, now, tr,
                                                 reason="lose_batch")
            else:                       # Sector-level host fault
                f.fire_stream(self._steps, master=sector.get("master"),
                              paths=tuple(sector.get("paths", ())))
        return failed

    def _abandon_batch(self, tickets: Sequence[Ticket], now: float,
                       tr: Any, reason: str) -> StreamBatch:
        self._batch_failures += 1
        tr.event("batch_lost", step=self._steps, tickets=len(tickets),
                 reason=reason)
        requeued = [t for t in tickets if self.queue.requeue(t, now=now)]
        return StreamBatch(step=self._steps, records=None,
                           valid=np.zeros((0,), bool), dropped=0,
                           delivered=[], requeued=requeued)

    def _recover_mesh(self, lost: int, ckpt: StreamCheckpoint,
                      tr: Any) -> None:
        """Mid-stream elastic recovery: re-form the survivor grid of ranks
        on the same device, restore the carry from the just-sealed
        checkpoint onto it (the FULL padded buffer — global row count
        unchanged, so one more cache miss), swap the inner executor, count
        the recovery."""
        from repro_torch.train import elastic
        inner = self.inner
        nb = _pinned_buckets(self.pipeline, inner.axis_size,
                             "mid-stream elastic recovery")
        with tr.span("stream.recover", step=self._steps, lost_device=lost):
            new_ranks = elastic.shrink_mesh(inner.ranks, inner.axes, lost, nb)
            new_inner = inner._sub_executor(new_ranks)
            if self._carry is not None:
                self._carry = None          # the lost grid's state
                self._carry = ckpt.restore_carry(new_inner.ranks, inner.axes)
            self._retired_cache.append(inner.cache_info())
            self.inner = new_inner
        if self.micro_batch % new_inner.axis_size:
            raise AssertionError(   # unreachable: new extent divides old
                "survivor mesh must divide the micro-batch")
        self._recoveries += 1
        REGISTRY.counter("stream.recoveries").inc()
        shape = dict(zip(inner.axes, new_inner.ranks.shape))
        self.chaos.events.append(
            f"batch {self._steps}: resumed stream on mesh {shape} "
            f"({new_inner.axis_size} devices); carry remeshed, "
            f"{len(ckpt.ticket_ids)} tickets requeued")

    # -- batch assembly / carry ----------------------------------------------
    def _assemble(self, tickets: Sequence[Ticket]):
        """The tickets' rows, padded to ``micro_batch``, rank-major into
        ``(ranks, micro_batch / ranks, ...)`` on the executor's device (one
        copy per leaf), with the ``(ranks, micro_batch / ranks)`` mask."""
        rows = [tree_flatten(t.payload)[0] for t in tickets]
        treedef = tree_flatten(tickets[0].payload)[1]
        n = sum(t.cost for t in tickets)
        ranks = self.inner.ranks
        world = ranks.world
        per = self.micro_batch // world
        leaves = []
        for parts in zip(*rows):
            tail = parts[0].shape[1:]
            buf = np.zeros((self.micro_batch,) + tail, parts[0].dtype)
            np.concatenate(parts, axis=0, out=buf[:n])
            leaves.append(ranks.stack(torch.from_numpy(buf).reshape(
                (world, per) + tuple(tail))))
        valid = np.zeros((self.micro_batch,), bool)
        valid[:n] = True
        valid = ranks.stack(torch.from_numpy(valid).reshape(world, per))
        return tree_unflatten(treedef, leaves), valid, n

    def _init_carry(self, batch, valid) -> Tuple[Any, Any]:
        """Zero carry state, shaped like the final reduce's output schema,
        and the carry contract's check: the reduce must be
        schema-preserving. The reference derives the schema by abstract
        evaluation; the port's kernels are host calls that no abstract
        tensor can run, so the pipeline's maps and reduces run once on a
        one-row-per-rank slice of the batch, on the executor's device
        (shuffles and sorts are skipped: they keep the schema). The
        kernel launches of this probe are kept in ``init_launches``."""
        df = self.pipeline
        carry_at = _last_reduce_index(df)
        before = _launches()
        records = tree_map(lambda a: a[:, :1], batch)
        valid = valid[:, :1]
        schemas = []
        for stage in df.stages[:carry_at + 1]:
            if isinstance(stage, MapStage):
                records = stage.fn(records)
                if _leading(records) != tuple(valid.shape):
                    valid = torch.ones(_leading(records), dtype=torch.bool,
                                       device=valid.device)
            elif isinstance(stage, ReduceStage):
                if stage is df.stages[carry_at]:
                    schemas.append(_schema(records))
                records, valid, _ = _split_reduce_out(
                    stage.fn(records, valid))
                valid = torch.as_tensor(valid).reshape(_leading(records))
            # shuffle/sort: schema-preserving, row count irrelevant
        schemas.append(_schema(records))
        after = _launches()
        self.init_launches = {k: after[k] - before[k] for k in after}
        (t_in, in_schema), (t_out, out_schema) = schemas
        if (t_in, in_schema) != (t_out, out_schema):
            raise ValueError(
                "streaming carry requires a schema-preserving reduce (its "
                "output is fed back into its input next batch); got input "
                f"schema {in_schema} vs output {out_schema}")
        rows = self.inner.ranks.rows
        per = self._carry_cap_total // self.inner.ranks.world
        dev = self.inner.device
        leaves = [torch.zeros((rows, per) + tuple(shape), dtype=dtype,
                              device=dev) for shape, dtype in out_schema]
        return (tree_unflatten(t_out, leaves),
                torch.zeros((rows, per), dtype=torch.bool, device=dev))

    def carry_state(self) -> Optional[Any]:
        """Dense numpy view of the current cross-batch aggregate (the valid
        carry rows, rank-major), or None before the first carried batch."""
        if self._carry is None:
            return None
        return _valid_rows(*self._carry)

    # -- stats ---------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Executor + per-tenant serving stats: throughput, plan-cache
        counters (``misses`` frozen after the first batch; a
        grid-shrinking recovery adds exactly one miss — retired grids'
        counters are summed in), queue depths, latency percentiles,
        timeout/requeue counts, mid-stream recoveries."""
        infos = [*self._retired_cache, self.inner.cache_info()]
        cache = infos[-1]._asdict()
        for key in ("hits", "misses", "evictions"):
            cache[key] = sum(getattr(i, key) for i in infos)
        secs = max(self._run_seconds, 1e-9)
        return {
            "steps": self._steps,
            "records_in": self._records_in,
            "records_per_s": self._records_in / secs,
            "run_seconds": self._run_seconds,
            "batch_failures": self._batch_failures,
            "recoveries": self._recoveries,
            "cache": cache,
            "tenants": self.queue.stats(),
        }


def _schema(records) -> Tuple[Any, Tuple]:
    """Treedef and per-leaf (trailing shape, dtype) of a stacked tree."""
    leaves, treedef = tree_flatten(records)
    return treedef, tuple((tuple(l.shape[2:]), l.dtype) for l in leaves)
