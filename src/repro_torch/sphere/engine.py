"""Sphere client orchestration (paper §3.4): ``SphereProcess.run``.

Port of ``repro/sphere/engine.py``: the segment loop, the locality rule,
the retries, ``recover`` and the error accounting are the reference's,
line for line. What differs is where the UDF runs: each SPE moves its
segment to the process's ``device`` (``cuda`` unless the caller passes
``"cpu"``), so the UDF gets tensors there. Bucket parts come back to the
host as numpy blocks, because they are uploaded to Sector.

"The client is responsible for orchestrating the complete running of each
Sphere process" — it segments the input stream (§3.5.1), assigns segments to
SPEs (scheduler rules), tracks per-segment status, retries failed segments on
other SPEs, reports UDF/data errors back to the application, and collects
results (or routes them to bucket files for the next stage).

This host-level engine actually executes UDFs over data stored in Sector —
it is what the host dataflow executor's Terasort data plane uses. The
stacked-ranks analogue of the same pattern is
:func:`repro_torch.core.udf.sphere_map`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import resolve_device
from repro_torch.core.records import RecordCodec
from repro_torch.core.retry import RetryPolicy
from repro_torch.core.stream import SegmentInfo, SphereStream
from repro_torch.obs.metrics import MS_BUCKETS, REGISTRY
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sector.master import Master
from repro_torch.sector.topology import NodeAddress
from repro_torch.sphere.spe import SPE, SegmentLost


@dataclasses.dataclass
class SphereResult:
    #: per-segment UDF outputs, indexed by segment index
    outputs: Dict[int, Any]
    #: segments that permanently failed with data/UDF errors (paper: reported
    #: to the application, not silently retried forever)
    errors: Dict[int, str]
    #: total SPE-level retries that fault tolerance absorbed
    retries: int
    #: mid-job Sector recoveries (lost bucket re-replicated from a survivor)
    recoveries: int = 0
    #: permanently failed segments surfaced as DATA_ERROR in ``errors`` —
    #: a non-zero count means the output is *incomplete*, not just retried
    data_errors: int = 0
    #: wall-clock seconds the whole stage took (one engine run = one phase
    #: of the host dataflow) — a cheap ``time.monotonic`` pair, recorded
    #: whether or not a tracer is attached
    elapsed_s: float = 0.0
    #: input segments successfully processed (NOT the bucket count —
    #: ``outputs`` is re-keyed by bucket when a ``bucket_fn`` is active)
    segments_processed: int = 0

    def concat(self) -> Any:
        parts = [self.outputs[i] for i in sorted(self.outputs)]
        if parts and isinstance(parts[0], torch.Tensor):
            return torch.cat(parts, dim=0)
        return np.concatenate(parts, axis=0)


def _host(recs: Any) -> np.ndarray:
    """A bucket part as a host numpy block (it is uploaded to Sector)."""
    if isinstance(recs, torch.Tensor):
        return recs.cpu().numpy()
    return np.asarray(recs)


class SphereProcess:
    """myproc.run(stream, udf) — the paper's client API (§3.1 pseudo-code)."""

    def __init__(self, master: Master, session_id: int,
                 spes: Sequence[SPE], max_retries: int = 2,
                 retry_policy: Optional[RetryPolicy] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 device: Any = None):
        self.master = master
        self.session_id = session_id
        self.spes = list(spes)
        self.max_retries = max_retries
        #: backoff between segment re-pools; the zero-base default keeps
        #: retries immediate while still recording the (zero) delays
        self.retry_policy = (RetryPolicy() if retry_policy is None
                             else retry_policy)
        self._sleep = time.sleep if sleep is None else sleep
        #: where the SPEs put their segments and run the UDF
        self.device = resolve_device(device)

    def _backoff(self, tr: Any, seg_i: int, attempt: int,
                 reason: str) -> None:
        """Account one re-pool: delay per the policy (keyed by segment so
        concurrent retriers de-synchronize), record it in the
        ``host.backoff_ms`` histogram, and stamp the ``retry`` trace event
        with the attempt number and the delay actually taken."""
        d = self.retry_policy.delay(max(0, attempt - 1), key=seg_i)
        REGISTRY.histogram("host.backoff_ms",
                           bounds=MS_BUCKETS).observe(d * 1e3)
        tr.event("retry", segment=seg_i, reason=reason, attempt=attempt,
                 delay_ms=round(d * 1e3, 3))
        if d > 0:
            self._sleep(d)

    def segment_stream(self, file_paths: Sequence[str], record_bytes: int,
                       s_min: int = 1, s_max: int = 1 << 30,
                       ) -> List[SegmentInfo]:
        files: List[Tuple[str, int]] = []
        total = 0
        for p in file_paths:
            meta = self.master.lookup(p)
            if meta is None:
                raise FileNotFoundError(p)
            nrec = meta.size // record_bytes
            files.append((p, nrec))
            total += nrec
        return SphereStream.plan_segments(
            total, record_bytes, files, s_min=s_min, s_max=s_max,
            num_spes=len(self.spes))

    def run(
        self,
        file_paths: Sequence[str],
        udf: Callable[[Any], Any],
        record_bytes: int,
        bucket_fn: Optional[Callable[[Any], Dict[int, Any]]] = None,
        num_buckets: int = 0,
        codec: Optional[RecordCodec] = None,
        s_min: int = 1,
        s_max: int = 1 << 30,
        recover: Optional[Callable[[str], Any]] = None,
        trace: Optional[Any] = None,
    ) -> SphereResult:
        """Execute ``udf`` over every segment; optionally route outputs to
        buckets (``bucket_fn`` maps a UDF output to {bucket_id: records}),
        which become the input stream of the next stage.

        ``codec``: when given, SPEs decode each raw ``(n, record_bytes)``
        byte segment (a uint8 tensor on ``device``; the UDF gets that
        tensor without a codec) into a structured record tree before
        calling ``udf``
        (the paper ships the UDF library *to* the SPE; the record schema
        rides along). ``s_min``/``s_max`` are the §3.5.1 segment-size clamp
        in bytes — pass a huge ``s_min`` to force whole-file segments (one
        bucket file = one reduce group for the dataflow host executor).

        ``recover``: called with the Sector path of a segment whose input
        bytes could not be fetched (every listed replica dead/missing, see
        :class:`repro_torch.sphere.spe.SegmentLost`). Normally
        ``SectorClient.recover`` — it restores the file from a surviving
        copy so the re-pooled segment succeeds; if it raises IOError the
        data is truly gone and the segment becomes a DATA_ERROR.

        ``trace``: a :class:`repro_torch.obs.trace.Tracer` — each segment
        attempt becomes a ``segment[i]`` span (with the SPE's read/udf
        sub-spans) annotated with its outcome; recoveries become nested
        ``recover[i]`` spans and re-pools emit ``retry`` instant events."""
        tr = trace if trace is not None else NULL_TRACER
        t_start = time.monotonic()
        segments = self.segment_stream(file_paths, record_bytes,
                                       s_min=s_min, s_max=s_max)
        outputs: Dict[int, Any] = {}
        errors: Dict[int, str] = {}
        buckets: Dict[int, List[Any]] = {b: [] for b in range(num_buckets)}
        retries = 0
        recoveries = 0

        # locality-greedy assignment, then round-robin execution with retry
        pending = list(range(len(segments)))
        rr = 0
        attempt: Dict[int, int] = {i: 0 for i in pending}
        live = [s for s in self.spes]
        while pending:
            seg_i = pending.pop(0)
            seg = segments[seg_i]
            if not live:
                errors[seg_i] = "no live SPEs"
                continue
            # rule 1: prefer an SPE co-located with a replica
            locs = [self.master.slaves[s].address
                    for s in (self.master.lookup(seg.file_path).locations)
                    if s in self.master.slaves and self.master.slaves[s].alive]
            def loc_key(spe: SPE):
                from repro_torch.sector.topology import distance
                d = min((distance(spe.address, a) for a in locs), default=3)
                return (d, spe.segments_done, spe.spe_id)
            if locs:
                spe = min(live, key=loc_key)
            else:
                # round-robin only advances when it actually picked — a
                # locality hit must not burn an rr slot for other segments
                spe = live[rr % len(live)]
                rr += 1
            with tr.span(f"segment[{seg_i}]", spe=spe.spe_id,
                         records=seg.num_records,
                         attempt=attempt[seg_i]) as ssp:
                try:
                    out = spe.process(seg, udf, record_bytes, codec=codec,
                                      trace=trace, device=self.device)
                except SegmentLost as e:          # input data lost; SPE fine
                    ssp.set(outcome="segment_lost")
                    attempt[seg_i] += 1
                    if recover is not None:
                        try:
                            with tr.span(f"recover[{seg_i}]", path=e.path):
                                recover(e.path)
                            recoveries += 1
                            REGISTRY.counter("host.recoveries").inc()
                        except (IOError, OSError) as gone:
                            errors[seg_i] = f"DATA_ERROR: {gone}"
                            REGISTRY.counter("host.data_errors").inc()
                            continue
                    if attempt[seg_i] > self.max_retries + len(self.spes):
                        errors[seg_i] = f"DATA_ERROR: gave up: {e}"
                        REGISTRY.counter("host.data_errors").inc()
                    else:
                        retries += 1
                        REGISTRY.counter("host.retries").inc()
                        self._backoff(tr, seg_i, attempt[seg_i],
                                      reason="segment_lost")
                        pending.append(seg_i)     # re-pool (paper §3.5.2)
                    continue
                except (IOError, OSError) as e:   # SPE/node failure
                    ssp.set(outcome="spe_failure")
                    live = [s for s in live if s is not spe]
                    attempt[seg_i] += 1
                    retries += 1
                    REGISTRY.counter("host.retries").inc()
                    if attempt[seg_i] > self.max_retries + len(self.spes):
                        errors[seg_i] = f"DATA_ERROR: gave up: {e}"
                        REGISTRY.counter("host.data_errors").inc()
                    else:
                        self._backoff(tr, seg_i, attempt[seg_i],
                                      reason="spe_failure")
                        pending.append(seg_i)     # reassign (paper §3.5.2)
                    continue
                except Exception as e:            # data/UDF error
                    ssp.set(outcome="udf_error")
                    attempt[seg_i] += 1
                    if attempt[seg_i] >= self.max_retries:
                        # report to application, *counted*: the output is
                        # missing this segment, the caller must be able to
                        # tell
                        errors[seg_i] = f"DATA_ERROR: {e!r}"
                        REGISTRY.counter("host.data_errors").inc()
                    else:
                        retries += 1
                        REGISTRY.counter("host.retries").inc()
                        self._backoff(tr, seg_i, attempt[seg_i],
                                      reason="udf_error")
                        pending.append(seg_i)
                    continue
                ssp.set(outcome="ok")
                REGISTRY.counter("host.segments").inc()
            outputs[seg_i] = out
            if bucket_fn is not None:
                # the paper: SPE dumps results locally first, then sends to
                # bucket handlers; handler accepts per-segment data exactly once
                for b, recs in bucket_fn(out).items():
                    buckets[b].append(_host(recs))

        result = SphereResult(
            outputs=outputs, errors=errors, retries=retries,
            recoveries=recoveries,
            data_errors=sum(1 for v in errors.values()
                            if v.startswith("DATA_ERROR")),
            elapsed_s=time.monotonic() - t_start,
            segments_processed=len(outputs))
        if bucket_fn is not None:
            # an empty bucket must keep the records' dtype and trailing dims
            # (np.zeros((0,)) would silently decay to 1-D float64)
            exemplar = next((recs[0] for recs in buckets.values() if recs),
                            None)
            def empty() -> np.ndarray:
                if exemplar is None:
                    return np.zeros((0,))
                return np.zeros((0,) + exemplar.shape[1:], exemplar.dtype)
            result.outputs = {
                b: (np.concatenate(v, axis=0) if v else empty())
                for b, v in buckets.items()
            }
        return result
