"""Sphere runtime (paper §3.3-3.5), port of ``repro.sphere``: SPEs, the
client-driven segment scheduler (locality rules, straggler duplication,
fault tolerance), the client orchestration engine, and the dataflow API
with its two executors — :class:`SPMDExecutor` over stacked ranks and
:class:`HostExecutor` over Sector files. Streaming and chaos are not
ported yet.
"""

from repro_torch.sphere.scheduler import (
    DeadlineHeap, SegmentScheduler, SPEState, SegmentState, ScheduleEvent,
)
from repro_torch.sphere.spe import SPE
from repro_torch.sphere.engine import SphereProcess
from repro_torch.sphere.dataflow import (
    Dataflow, DataflowResult, HostExecutor, SPMDExecutor,
)

__all__ = [
    "DeadlineHeap", "SegmentScheduler", "SPEState", "SegmentState",
    "ScheduleEvent",
    "SPE", "SphereProcess",
    "Dataflow", "DataflowResult", "HostExecutor", "SPMDExecutor",
]
