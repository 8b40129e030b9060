"""Training driver of the port: for now only :func:`make_sector`.

Port of ``make_sector`` from ``repro/launch/train.py``, which brings up an
in-process Sector deployment (security server, master, slaves,
replication daemon). The tests and ``chip_smoke.py`` build their
deployments with it; the rest of the driver (the Sphere-scheduled data
pipeline, the train step, Sector-backed checkpoints) follows with the
port of the trainer.
"""

from __future__ import annotations

import os

from repro_torch.sector import (Master, NodeAddress, ReplicationDaemon,
                                SectorClient, SecurityServer, SlaveNode,
                                Topology)


def make_sector(root: str, num_slaves: int = 4, replication: int = 2):
    sec = SecurityServer()
    sec.add_user("trainer", "pw")
    sec.allow_slaves("10.0.0.0/8")
    master = Master(sec, replication_factor=replication)
    topo = Topology(pods=1, racks=2, nodes_per_rack=(num_slaves + 1) // 2)
    for i in range(num_slaves):
        addr = topo.address_of(i)
        master.register_slave(SlaveNode(
            i, addr, os.path.join(root, f"slave{i}"), ip=f"10.0.0.{i + 1}"))
    client = SectorClient(master, "trainer", "pw",
                          client_addr=NodeAddress(0, 0, 0))
    return master, client, ReplicationDaemon(master)
