"""Sphere runtime (paper §3.3-3.5), port of ``repro.sphere``: SPEs, the
client-driven segment scheduler (locality rules, straggler duplication,
fault tolerance), the client orchestration engine, the dataflow API with
its two executors — :class:`SPMDExecutor` over stacked ranks and
:class:`HostExecutor` over Sector files — the streaming executor with its
multi-tenant admission queue, and the chaos layer (fault plans, schedules,
hop and stream checkpoints).
"""

from repro_torch.sphere.scheduler import (
    DeadlineHeap, SegmentScheduler, SPEState, SegmentState, ScheduleEvent,
)
from repro_torch.sphere.spe import SPE
from repro_torch.sphere.engine import SphereProcess
from repro_torch.sphere.dataflow import (
    Dataflow, DataflowResult, HostExecutor, SPMDExecutor,
)
from repro_torch.sphere.chaos import (
    ChaosSchedule, FaultPlan, HopCheckpoint, StreamCheckpoint,
)
from repro_torch.sphere.streaming import (
    QueueFull, StreamBatch, StreamExecutor, TenantQueue, Ticket,
)

__all__ = [
    "DeadlineHeap", "SegmentScheduler", "SPEState", "SegmentState",
    "ScheduleEvent",
    "SPE", "SphereProcess",
    "Dataflow", "DataflowResult", "HostExecutor", "SPMDExecutor",
    "ChaosSchedule", "FaultPlan", "HopCheckpoint", "StreamCheckpoint",
    "QueueFull", "StreamBatch", "StreamExecutor", "TenantQueue", "Ticket",
]
