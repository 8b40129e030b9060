"""Nested-span tracer with Perfetto export (paper §4's per-stage timing).

The paper's evaluation lives on per-stage wall-clock breakdowns; this module
is the repo's way to produce them without pulling in an external tracing
stack. Design rules:

- **Explicit clock injection.** ``Tracer(clock=...)`` takes any zero-arg
  callable returning a monotonic float — ``time.perf_counter`` by default,
  a virtual counter in tests (the same discipline as ``TenantQueue``'s
  ``now=`` and ``ReplicationDaemon``'s ``clock=``), so span durations are
  deterministic under test.
- **Nested spans via a per-thread stack.** ``with tracer.span("x"): ...``
  parents to whatever span is open on the *current thread*; the buffer is
  shared and lock-protected, so SPE worker threads can trace concurrently.
- **Spans are cheap and final-on-exit.** A span is appended to the buffer
  once, when it closes; ``Span.set(**attrs)`` may add attributes while it
  is open (e.g. a drop count known only after execution).
- **Tracks.** ``tracer.fork("host")`` returns a tracer writing to the SAME
  buffer under a different track name — one Perfetto file can hold the SPMD
  and host executors side by side as separate threads.

Exports: :meth:`Tracer.to_perfetto` writes Chrome/Perfetto ``trace_event``
JSON (open in https://ui.perfetto.dev or chrome://tracing);
:meth:`Tracer.flame` renders an aggregated plain-text flame summary.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Span", "TraceBuffer", "Tracer", "NullTracer", "NULL_TRACER"]


@dataclasses.dataclass
class Span:
    """One closed (or still-open) span. ``start``/``end`` are in the
    tracer's clock units (seconds under the default clock)."""

    name: str
    start: float
    end: Optional[float] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    span_id: int = 0
    parent_id: Optional[int] = None
    track: str = "main"

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes to the open span (chainable)."""
        self.attrs.update(attrs)
        return self


@dataclasses.dataclass
class _Event:
    """An instant marker (Perfetto ``ph: "i"``) — e.g. a retry."""

    name: str
    ts: float
    attrs: Dict[str, Any]
    parent_id: Optional[int]
    track: str


class TraceBuffer:
    """Thread-safe append-only store of closed spans and instant events.
    Shared between a tracer and its :meth:`Tracer.fork` children."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._events: List[_Event] = []
        self._ids = itertools.count(1)

    def next_id(self) -> int:
        return next(self._ids)

    def add_span(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def add_event(self, event: _Event) -> None:
        with self._lock:
            self._events.append(event)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def events(self) -> List[_Event]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


def _json_safe(v: Any) -> Any:
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    try:                          # numpy / torch scalars
        return v.item()
    except (AttributeError, ValueError):
        return str(v)


class Tracer:
    """Span tracer (see module docstring). ``enabled`` distinguishes a real
    tracer from :data:`NULL_TRACER` so hot paths can skip work (device
    syncs, attribute computation) that only matters when tracing."""

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 buffer: Optional[TraceBuffer] = None, track: str = "main"):
        self.clock = clock if clock is not None else time.perf_counter
        self.buffer = buffer if buffer is not None else TraceBuffer()
        self.track = track
        self._tls = threading.local()

    # -- recording -----------------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, **attrs: Any) -> "_SpanContext":
        return _SpanContext(self, name, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instant marker under the currently open span."""
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        self.buffer.add_event(_Event(
            name=name, ts=self.clock(),
            attrs={k: _json_safe(v) for k, v in attrs.items()},
            parent_id=parent, track=self.track))

    def fork(self, track: str) -> "Tracer":
        """A tracer sharing this buffer and clock under another track —
        renders as a separate thread row in Perfetto."""
        return Tracer(clock=self.clock, buffer=self.buffer, track=track)

    # -- export --------------------------------------------------------------
    def _tracks(self) -> List[str]:
        seen: List[str] = []
        for sp in self.buffer.spans():
            if sp.track not in seen:
                seen.append(sp.track)
        for ev in self.buffer.events():
            if ev.track not in seen:
                seen.append(ev.track)
        return seen

    def to_perfetto(self, path: Optional[str] = None) -> Any:
        """Chrome/Perfetto ``trace_event`` JSON. With ``path``, writes the
        file and returns the path; otherwise returns the dict."""
        spans = self.buffer.spans()
        events = self.buffer.events()
        t0 = min([s.start for s in spans] + [e.ts for e in events],
                 default=0.0)
        tids = {t: i for i, t in enumerate(self._tracks())}
        out: List[Dict[str, Any]] = [
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
             "args": {"name": track}}
            for track, tid in tids.items()
        ]
        for sp in spans:
            end = sp.end if sp.end is not None else sp.start
            out.append({
                "name": sp.name, "cat": sp.track, "ph": "X",
                "ts": (sp.start - t0) * 1e6, "dur": (end - sp.start) * 1e6,
                "pid": 0, "tid": tids[sp.track],
                "args": {k: _json_safe(v) for k, v in sp.attrs.items()},
            })
        for ev in events:
            out.append({
                "name": ev.name, "cat": ev.track, "ph": "i", "s": "t",
                "ts": (ev.ts - t0) * 1e6, "pid": 0, "tid": tids[ev.track],
                "args": dict(ev.attrs),
            })
        out.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
        payload = {"traceEvents": out, "displayTimeUnit": "ms"}
        if path is None:
            return payload
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return path

    def flame(self) -> str:
        """Aggregated plain-text flame summary: one line per distinct span
        path (``a/b/c``), sorted by total time; ``self`` excludes child
        span time."""
        spans = self.buffer.spans()
        by_id = {s.span_id: s for s in spans}
        child_time: Dict[int, float] = {}
        for s in spans:
            if s.parent_id is not None and s.duration is not None:
                child_time[s.parent_id] = (child_time.get(s.parent_id, 0.0)
                                           + s.duration)

        def path(s: Span) -> str:
            parts = [s.name]
            seen = {s.span_id}
            cur = s
            while cur.parent_id is not None and cur.parent_id in by_id:
                cur = by_id[cur.parent_id]
                if cur.span_id in seen:    # defensive: no cycles
                    break
                seen.add(cur.span_id)
                parts.append(cur.name)
            parts.append(s.track)
            return "/".join(reversed(parts))

        agg: Dict[str, Tuple[float, float, int]] = {}
        for s in spans:
            dur = s.duration or 0.0
            self_t = dur - child_time.get(s.span_id, 0.0)
            p = path(s)
            tot, slf, cnt = agg.get(p, (0.0, 0.0, 0))
            agg[p] = (tot + dur, slf + self_t, cnt + 1)
        lines = [f"{'total_ms':>10} {'self_ms':>10} {'count':>6}  path"]
        for p, (tot, slf, cnt) in sorted(agg.items(),
                                         key=lambda kv: -kv[1][0]):
            lines.append(f"{tot * 1e3:10.3f} {slf * 1e3:10.3f} {cnt:6d}  {p}")
        return "\n".join(lines)


class _SpanContext:
    """Context manager for one span: opens on ``__enter__``, pushes onto the
    thread's stack, appends to the buffer on ``__exit__``."""

    __slots__ = ("_tracer", "_name", "_attrs", "_span")

    def __init__(self, tracer: Tracer, name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._span: Optional[Span] = None

    def __enter__(self) -> Span:
        tr = self._tracer
        stack = tr._stack()
        self._span = Span(
            name=self._name, start=tr.clock(), attrs=dict(self._attrs),
            span_id=tr.buffer.next_id(),
            parent_id=stack[-1].span_id if stack else None, track=tr.track)
        stack.append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        tr = self._tracer
        sp = self._span
        stack = tr._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        sp.end = tr.clock()
        if exc_type is not None:
            sp.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        tr.buffer.add_span(sp)
        return False


class _NullSpan:
    __slots__ = ()
    name = ""
    attrs: Dict[str, Any] = {}

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


class _NullContext:
    __slots__ = ()
    _SPAN = _NullSpan()

    def __enter__(self) -> _NullSpan:
        return self._SPAN

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


class NullTracer:
    """Do-nothing tracer: executors use it when no trace is requested so
    the hot path has no branches beyond one attribute check. Falsy, so
    ``trace or NULL_TRACER`` composes."""

    enabled = False
    _CTX = _NullContext()

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, **attrs: Any) -> _NullContext:
        return self._CTX

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def fork(self, track: str) -> "NullTracer":
        return self


NULL_TRACER = NullTracer()
