"""Transport model (paper §2.4).

The paper uses GMP (UDP messaging) + UDT (high-throughput wide-area transfer)
and reports Terasort/SDSS numbers bounded by disk IO or the WAN. On the TPU
target the fabric hierarchy is ICI (intra-pod, lossless, ~50 GB/s/link) and
DCN (inter-pod); disks become the checkpoint/dataset path.

``TransferSimulator`` assigns each (src, dst) pair a link class from the
topology distance and computes transfer times for the SDSS-distribution and
Terasort benchmarks. It also models the paper's key UDT property: throughput
over high-BDP paths does not collapse with distance (vs TCP, which we model
with a distance penalty) — this is what made wide-area Sector feasible.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.sector.topology import (
    DIST_CROSS_POD, DIST_SAME_NODE, DIST_SAME_POD, DIST_SAME_RACK,
    NodeAddress, distance,
)


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Bandwidth in bytes/s and one-way latency in seconds."""
    bandwidth: float
    latency: float


#: Default link table, TPU-flavoured but with the paper's hierarchy:
#: node-local disk, intra-rack (1 GE in the paper -> ICI here), intra-pod
#: (10 GE -> ICI), cross-pod (wide area 10 GE -> DCN).
DEFAULT_LINKS: Dict[int, LinkSpec] = {
    DIST_SAME_NODE: LinkSpec(bandwidth=819e9, latency=1e-7),   # HBM-resident
    DIST_SAME_RACK: LinkSpec(bandwidth=50e9, latency=1e-6),    # ICI link
    DIST_SAME_POD: LinkSpec(bandwidth=50e9, latency=4e-6),     # ICI multi-hop
    DIST_CROSS_POD: LinkSpec(bandwidth=12.5e9, latency=500e-6),  # DCN
}

#: Paper-era link table (Open Cloud Testbed): 1 GE in-rack, 10 GE between
#: racks/sites, 4 GB/s local disk-ish memory path, ~50 MB/s single disk.
PAPER_LINKS: Dict[int, LinkSpec] = {
    DIST_SAME_NODE: LinkSpec(bandwidth=4e9, latency=1e-6),
    DIST_SAME_RACK: LinkSpec(bandwidth=125e6, latency=100e-6),   # 1 GE
    DIST_SAME_POD: LinkSpec(bandwidth=1.25e9, latency=1e-3),     # 10 GE
    DIST_CROSS_POD: LinkSpec(bandwidth=1.25e9, latency=30e-3),   # 10 GE WAN
}

PAPER_DISK_BW = 50e6  # ~single 1TB SATA disk of a Dell 1435 (paper Fig 4 note)


class TransferSimulator:
    """Computes transfer times and aggregates benchmark statistics."""

    def __init__(self, links: Optional[Dict[int, LinkSpec]] = None,
                 protocol: str = "udt", disk_bw: Optional[float] = None):
        self.links = dict(links or DEFAULT_LINKS)
        assert protocol in ("udt", "tcp")
        self.protocol = protocol
        self.disk_bw = disk_bw
        self.bytes_moved = 0.0
        self.time_busy = 0.0

    def link_for(self, src: NodeAddress, dst: NodeAddress) -> LinkSpec:
        return self.links[distance(src, dst)]

    def effective_bandwidth(self, src: NodeAddress, dst: NodeAddress) -> float:
        """UDT sustains the pipe; TCP throughput degrades with RTT (modelled
        as BW / (1 + rtt/25ms) — a coarse fit to 2008-era TCP on long fat
        pipes, cf. the UDT paper [11]). Disk bandwidth caps everything when
        configured (paper Fig 4: 'the bottleneck is the disk IO speed')."""
        link = self.link_for(src, dst)
        bw = link.bandwidth
        if self.protocol == "tcp":
            rtt = 2 * link.latency
            bw = bw / (1.0 + rtt / 25e-3)
        if self.disk_bw is not None:
            bw = min(bw, self.disk_bw)
        return bw

    def transfer_time(self, src: NodeAddress, dst: NodeAddress, nbytes: int) -> float:
        link = self.link_for(src, dst)
        # rendezvous setup: one RTT of the master-coordinated handshake
        t = 2 * link.latency + nbytes / self.effective_bandwidth(src, dst)
        self.bytes_moved += nbytes
        self.time_busy += t
        return t
