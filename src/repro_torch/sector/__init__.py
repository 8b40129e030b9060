"""Sector: the storage cloud (paper §2).

A file-based distributed storage system: a metadata master, slave nodes that
store whole-file *slices* on their native filesystem, an independent security
server, and a periodic topology-aware replication daemon.

This is an in-process, filesystem-backed implementation: every slave owns a
real directory; the master's metadata index is recoverable by scanning those
directories (the paper's central design argument for whole-file slices).
It backs the training framework's dataset pipeline and checkpoint store.

A copy of the framework-free ``repro.sector`` package (the port imports
nothing of ``repro``); the host executor
(:class:`repro_torch.sphere.dataflow.HostExecutor`) stores its inputs and
bucket files here.
"""

from repro_torch.sector.topology import NodeAddress, Topology, distance
from repro_torch.sector.security import SecurityServer, AccessDenied
from repro_torch.sector.slave import SlaveNode
from repro_torch.sector.master import (FailureDetector, FileMeta, Master,
                                 ReplicationDaemon)
from repro_torch.sector.client import SectorClient
from repro_torch.sector.transport import LinkSpec, TransferSimulator

__all__ = [
    "NodeAddress", "Topology", "distance",
    "SecurityServer", "AccessDenied",
    "SlaveNode", "Master", "FileMeta", "FailureDetector",
    "ReplicationDaemon", "SectorClient", "LinkSpec", "TransferSimulator",
]
