"""Client-driven segment scheduler (paper §3.5).

Implements the paper's scheduling rules verbatim:

  1. "Each data segment is assigned to an SPE on the same node if there is
     one available."  (data locality)
  2. "Segments from the same file are processed at the same time unless
     following this rule leaves SPEs idle."  (read concurrency: prefer to
     spread *distinct* files across simultaneously-running SPEs)
  3. "If there are still idle SPEs available ... assign them parts of data
     segments to process in the same order as they occur in the input
     stream."

plus the fault-tolerance and straggler policies of §3.5.2:

  - an SPE that misses its progress heartbeat past ``timeout`` is discarded
    and its segment goes back to the pool (re-executed from scratch — Sphere
    does no SPE checkpointing);
  - near the end, idle SPEs are assigned *duplicates* of still-running
    segments and the client takes whichever copy finishes first;
  - a segment that fails ``max_data_errors`` times with a *data* error (bad
    input / UDF bug) is reported to the client, not retried elsewhere.

The implementation is a deterministic discrete-event simulation: the same
logic drives host-level data-pipeline assignment (``static_assignment``) and
the runnability tests/benchmarks (``run``).
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set, \
    Tuple, Union

from repro_torch.core.stream import SegmentInfo
from repro_torch.sector.topology import (DIST_CROSS_POD, DIST_SAME_POD,
                                   DIST_SAME_RACK, NodeAddress, distance)


class SegStatus(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    DATA_ERROR = "data_error"


@dataclasses.dataclass
class SPEState:
    spe_id: int
    address: NodeAddress
    speed: float = 1.0           # records / second
    alive: bool = True
    fail_at: Optional[float] = None   # injected crash time
    busy_until: float = 0.0
    current: Optional[int] = None     # segment index being processed
    processed: int = 0


@dataclasses.dataclass
class SegmentState:
    info: SegmentInfo
    locations: List[NodeAddress]      # replicas (from the Sector master)
    status: SegStatus = SegStatus.PENDING
    running_on: Set[int] = dataclasses.field(default_factory=set)
    completed_by: Optional[int] = None
    attempts: int = 0
    data_errors: int = 0


@dataclasses.dataclass(frozen=True)
class ScheduleEvent:
    time: float
    kind: str                 # assign / complete / timeout / duplicate / error
    spe_id: int
    segment: int


class DeadlineHeap:
    """Min-heap of ``(deadline, item)`` with lazy invalidation — the same
    stale-event discipline the :class:`SegmentScheduler` simulation uses for
    its timeout events, factored out so live queues (the streaming
    :class:`repro_torch.sphere.streaming.TenantQueue`) can share it.

    Entries are never removed eagerly: when an item's deadline is refreshed
    (requeue) a new entry is pushed and the old one goes stale. ``pop_due``
    hands back ``(deadline, item)`` pairs and the *caller* decides staleness
    (typically: the recorded deadline no longer matches the item's current
    one, or the item already left the state the deadline guarded)."""

    def __init__(self):
        self._heap: List[Tuple[float, int, object]] = []
        self._seq = itertools.count()

    def push(self, deadline: float, item: object) -> None:
        heapq.heappush(self._heap, (deadline, next(self._seq), item))

    def pop_due(self, now: float) -> List[Tuple[float, object]]:
        due = []
        while self._heap and self._heap[0][0] <= now:
            deadline, _, item = heapq.heappop(self._heap)
            due.append((deadline, item))
        return due

    def peek(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)


class SegmentScheduler:
    def __init__(
        self,
        segments: Sequence[SegmentInfo],
        spes: Sequence[SPEState],
        locations: Dict[str, List[NodeAddress]],
        timeout: float = 60.0,
        speculate: bool = True,
        max_data_errors: int = 2,
        remote_read_penalty: Union[float, Mapping[int, float]] = 2.0,
        shuffle_plan=None,
    ):
        """``remote_read_penalty`` is either the legacy scalar (applied to any
        non-local read) or a mapping from topology distance class
        (:mod:`repro_torch.sector.topology` ``DIST_*``) to a slowdown multiplier —
        cross-pod reads ride the WAN and should cost more than same-rack. A
        mapping must price every remote class (1, 2, 3) explicitly so a
        partial map cannot silently make remote reads free; DIST_SAME_NODE
        may be omitted (defaults to 1.0).

        ``shuffle_plan``: an optional :class:`repro_torch.core.shuffle.ShufflePlan`
        (duck-typed — only ``.hierarchical`` is read). When the downstream
        shuffle is hierarchical, segments of one file should stay
        pod-coherent: their bucket output aggregates intra-DC in stage A
        before crossing the WAN once, so scattering a file's segments across
        pods multiplies stage-B traffic. The assignment rules gain a
        pod-coherence tiebreak in that case.
        """
        self.segments = [
            SegmentState(info=s, locations=list(locations.get(s.file_path, [])))
            for s in segments
        ]
        self.spes = {s.spe_id: s for s in spes}
        self.timeout = timeout
        self.speculate = speculate
        self.max_data_errors = max_data_errors
        if isinstance(remote_read_penalty, Mapping):
            missing = {DIST_SAME_RACK, DIST_SAME_POD,
                       DIST_CROSS_POD} - set(remote_read_penalty)
            if missing:
                raise ValueError("remote_read_penalty mapping must price "
                                 f"every remote distance class; missing "
                                 f"{sorted(missing)}")
        self.remote_read_penalty = remote_read_penalty
        self.shuffle_plan = shuffle_plan
        self.events: List[ScheduleEvent] = []

    def _read_penalty(self, dloc: int) -> float:
        """Slowdown multiplier for reading input at topology distance dloc."""
        if isinstance(self.remote_read_penalty, Mapping):
            return float(self.remote_read_penalty.get(dloc, 1.0))
        return 1.0 if dloc == 0 else float(self.remote_read_penalty)

    # -- the paper's assignment rules ------------------------------------
    def _pick_segment(self, spe: SPEState, now: float) -> Optional[int]:
        pending = [i for i, s in enumerate(self.segments)
                   if s.status == SegStatus.PENDING]
        if pending:
            running_files = {self.segments[i].info.file_path
                             for i, s in enumerate(self.segments)
                             if s.status == SegStatus.RUNNING}

            hier = (self.shuffle_plan is not None
                    and getattr(self.shuffle_plan, "hierarchical", False))
            file_pods: Dict[str, Set[int]] = {}
            if hier:
                # pods already committed to each *pending* file — running
                # and completed segments, so affinity survives sequential
                # processing on few SPEs. One O(segments) scan per pick,
                # same cost class as the pending/running_files scans above.
                pending_files = {self.segments[i].info.file_path
                                 for i in pending}
                for s in self.segments:
                    if s.info.file_path not in pending_files:
                        continue
                    pods = file_pods.setdefault(s.info.file_path, set())
                    if s.status == SegStatus.RUNNING:
                        for sid in s.running_on:
                            pods.add(self.spes[sid].address.pod)
                    elif (s.status == SegStatus.DONE
                          and s.completed_by is not None):
                        pods.add(self.spes[s.completed_by].address.pod)

            def rule_key(i: int) -> Tuple:
                seg = self.segments[i]
                # rule 1: locality — min topology distance to a replica
                dloc = min((distance(spe.address, a) for a in seg.locations),
                           default=3)
                # rule 2: prefer files NOT already being read (spread reads
                # over distinct files); but never leave the SPE idle (we are
                # already committed to assigning something).
                same_file_penalty = 1 if seg.info.file_path in running_files else 0
                # rule 2b (two-level shuffle only): keep a file's segments
                # pod-coherent so their bucket output aggregates intra-DC
                # (stage A) before crossing the WAN once in stage B.
                pod_penalty = 0
                if hier:
                    pods = file_pods.get(seg.info.file_path)
                    if pods and spe.address.pod not in pods:
                        pod_penalty = 1
                # rule 3: stream order
                return (dloc, same_file_penalty, pod_penalty, seg.info.index)

            return min(pending, key=rule_key)

        # tail: speculative duplicates of still-running segments (§3.5.2)
        if self.speculate:
            running = [i for i, s in enumerate(self.segments)
                       if s.status == SegStatus.RUNNING
                       and spe.spe_id not in s.running_on]
            if running:
                # duplicate the one that started earliest (most overdue)
                return min(running, key=lambda i: self.segments[i].info.index)
        return None

    def _proc_time(self, spe: SPEState, seg: SegmentState) -> float:
        base = seg.info.num_records / spe.speed
        dloc = min((distance(spe.address, a) for a in seg.locations), default=3)
        return base * self._read_penalty(dloc)  # remote read (rule-1 rationale)

    # -- static assignment for the data pipeline --------------------------
    def static_assignment(self) -> Dict[int, List[int]]:
        """One pass of rules 1-3 assigning every segment to exactly one SPE
        (round-robin over SPEs, locality-greedy). Used to map dataset segments
        to hosts before a training run; no simulation."""
        assignment: Dict[int, List[int]] = {sid: [] for sid in self.spes}
        load = {sid: 0 for sid in self.spes}
        for i, seg in enumerate(self.segments):
            def key(sid: int) -> Tuple:
                spe = self.spes[sid]
                dloc = min((distance(spe.address, a) for a in seg.locations),
                           default=3)
                return (load[sid], dloc, sid)
            best = min(self.spes, key=key)
            assignment[best].append(i)
            load[best] += seg.info.num_records
        return assignment

    # -- discrete-event simulation -----------------------------------------
    def run(self, fail_segments: Optional[Set[int]] = None) -> Dict[str, float]:
        """Simulate the full Sphere process; returns summary stats.

        ``fail_segments``: segment indices whose *data* is bad — every attempt
        raises a data error (paper: reported to client, never retried on
        another SPE beyond max_data_errors).
        """
        fail_segments = fail_segments or set()
        counter = itertools.count()
        heap: List[Tuple[float, int, str, int, int]] = []  # (t, seq, kind, spe, seg)
        now = 0.0
        last_useful = 0.0   # time of the last segment-state transition;
        #                     zombie duplicate completions don't extend it

        def log(kind: str, spe_id: int, seg_i: int, t: float) -> None:
            self.events.append(ScheduleEvent(t, kind, spe_id, seg_i))

        def try_assign(spe: SPEState, t: float) -> None:
            if not spe.alive or spe.current is not None:
                return
            seg_i = self._pick_segment(spe, t)
            if seg_i is None:
                return
            seg = self.segments[seg_i]
            dup = seg.status == SegStatus.RUNNING
            seg.status = SegStatus.RUNNING
            seg.running_on.add(spe.spe_id)
            seg.attempts += 1
            spe.current = seg_i
            dt = self._proc_time(spe, seg)
            spe.busy_until = t + dt
            if spe.fail_at is not None and spe.fail_at < t + dt:
                # SPE dies mid-segment: client sees heartbeat loss at
                # fail time + timeout
                heapq.heappush(heap, (spe.fail_at + self.timeout, next(counter),
                                      "timeout", spe.spe_id, seg_i))
            else:
                heapq.heappush(heap, (t + dt, next(counter),
                                      "complete", spe.spe_id, seg_i))
            log("duplicate" if dup else "assign", spe.spe_id, seg_i, t)

        for spe in self.spes.values():
            try_assign(spe, now)

        while heap:
            now, _, kind, spe_id, seg_i = heapq.heappop(heap)
            spe = self.spes[spe_id]
            seg = self.segments[seg_i]
            if kind == "complete":
                if not spe.alive or spe.current != seg_i:
                    continue  # stale event
                spe.current = None
                if seg.status == SegStatus.DONE:
                    pass  # a speculative twin already finished
                elif seg_i in fail_segments:
                    seg.data_errors += 1
                    seg.running_on.discard(spe_id)
                    log("error", spe_id, seg_i, now)
                    last_useful = now
                    if seg.data_errors >= self.max_data_errors:
                        seg.status = SegStatus.DATA_ERROR
                    else:
                        seg.status = SegStatus.PENDING
                else:
                    seg.status = SegStatus.DONE
                    seg.completed_by = spe_id
                    seg.running_on.discard(spe_id)
                    spe.processed += seg.info.num_records
                    log("complete", spe_id, seg_i, now)
                    last_useful = now
                try_assign(spe, now)
                # completion may free speculation slots for other idle SPEs
                for other in self.spes.values():
                    try_assign(other, now)
            elif kind == "timeout":
                if spe.fail_at is not None and spe.alive:
                    spe.alive = False  # discard the SPE (paper §3.5.2)
                    spe.current = None
                    log("timeout", spe_id, seg_i, now)
                    if seg.status == SegStatus.RUNNING:
                        seg.running_on.discard(spe_id)
                        if not seg.running_on:
                            seg.status = SegStatus.PENDING
                    for other in self.spes.values():
                        try_assign(other, now)

        done = sum(1 for s in self.segments if s.status == SegStatus.DONE)
        err = sum(1 for s in self.segments if s.status == SegStatus.DATA_ERROR)
        return {
            "makespan": last_useful,
            "done": done,
            "data_errors": err,
            "unfinished": len(self.segments) - done - err,
            "attempts": sum(s.attempts for s in self.segments),
        }
