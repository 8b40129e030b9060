"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Unifies the accounting that used to live in scattered result fields —
shuffle wire bytes and collective counts, partition/sort drops, host
retries/recoveries/data-errors, SPMD compile-cache hit/miss/evictions,
per-tenant queue latency — behind one ``snapshot()`` / ``to_json()`` API.

Conventions (documented in docs/OBSERVABILITY.md):

- Names are dotted, ``<subsystem>.<noun>``: ``spmd.shuffle.wire_bytes``,
  ``host.retries``, ``tenant.latency``. Label sets render Prometheus-style
  into the key: ``tenant.latency{tenant="batch"}``.
- Histograms use **fixed bucket boundaries** (powers of two by default), so
  the reported percentiles are deterministic functions of the observation
  multiset — a percentile is the smallest bucket upper bound covering the
  quantile, never an interpolation that shifts with sample order.
- One process-wide default registry (:data:`REGISTRY`); executors publish
  there unless handed their own. ``reset()`` exists for tests.

Everything is lock-protected and dependency-free.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "DEFAULT_BUCKETS", "MS_BUCKETS"]

#: default histogram boundaries: powers of two from ~1µs to 64s (seconds
#: scale) — wide enough for latencies and deterministic for percentiles.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(2.0 ** e for e in range(-20, 7))

#: millisecond-scale boundaries for retry/backoff-delay histograms
#: (``host.backoff_ms``, ``tenant.backoff_ms``, ``sector.recover.backoff_ms``):
#: a leading 0.0 bound gives zero-delay retries their own bucket, then powers
#: of two from ~1µs to ~131s expressed in ms.
MS_BUCKETS: Tuple[float, ...] = (0.0,) + tuple(2.0 ** e for e in range(-10, 18))


class Counter:
    """Monotonic float counter."""

    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": self.kind, "value": self._value}


class Gauge:
    """Last-write-wins value."""

    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": self.kind, "value": self._value}


class Histogram:
    """Fixed-boundary histogram with deterministic percentiles.

    ``bounds`` are bucket *upper* bounds; one implicit overflow bucket
    (+inf) catches the rest. :meth:`percentile` returns the smallest upper
    bound whose cumulative count covers the quantile (``inf`` if only the
    overflow bucket does) — a pure function of the observation multiset."""

    kind = "histogram"

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS):
        b = tuple(sorted(float(x) for x in bounds))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = b
        self._lock = threading.Lock()
        self._counts = [0] * (len(b) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        """Deterministic quantile: the smallest bucket upper bound covering
        ``q`` percent of observations (0 when empty)."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            need = q / 100.0 * total
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= need and cum > 0:
                    return (self.bounds[i] if i < len(self.bounds)
                            else math.inf)
            return math.inf

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        snap = {"type": self.kind, "count": total, "sum": s,
                "buckets": {("inf" if i == len(self.bounds)
                             else repr(self.bounds[i])): c
                            for i, c in enumerate(counts) if c}}
        snap["p50"] = self.percentile(50)
        snap["p99"] = self.percentile(99)
        return snap


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Create-or-fetch registry of named instruments (see module
    docstring). ``snapshot()`` returns a key-sorted plain dict, so its JSON
    form is stable across runs with the same event multiset."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, labels: Dict[str, Any], cls, *args):
        key = _key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(*args)
            elif not isinstance(m, cls):
                raise ValueError(f"metric {key!r} already registered as "
                                 f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None,
                  **labels: Any) -> Histogram:
        return self._get(name, labels, Histogram,
                         DEFAULT_BUCKETS if bounds is None else bounds)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            items = sorted(self._metrics.items())
        return {k: m.snapshot() for k, m in items}

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> Any:
        snap = self.snapshot()
        if path is None:
            return json.dumps(snap, indent=indent, sort_keys=True)
        with open(path, "w") as f:
            json.dump(snap, f, indent=indent, sort_keys=True)
        return path

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


#: the process-wide default registry every instrumented component uses
#: unless constructed with an explicit one.
REGISTRY = MetricsRegistry()
