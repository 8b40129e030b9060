"""Hierarchical system topology (paper §2.2).

The paper assumes a manually-specified hierarchical topology: nodes on racks,
racks in data centers, data centers connected by wide-area links. The master
uses it to pick replica locations and to serve clients from nearby slaves.

On the TPU-pod target the hierarchy is host → ICI pod → DCN-connected pods;
we keep the paper's (pod, rack, node) naming with pod = data center.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Sequence


@dataclasses.dataclass(frozen=True, order=True)
class NodeAddress:
    """Position of a node in the hierarchy (data center / rack / node)."""

    pod: int
    rack: int
    node: int

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return f"pod{self.pod}/rack{self.rack}/node{self.node}"


#: Topology distance classes, small = close (paper: pick close, non-busy slave).
DIST_SAME_NODE = 0
DIST_SAME_RACK = 1
DIST_SAME_POD = 2
DIST_CROSS_POD = 3


def distance(a: NodeAddress, b: NodeAddress) -> int:
    """Hierarchical distance between two nodes."""
    if a.pod != b.pod:
        return DIST_CROSS_POD
    if a.rack != b.rack:
        return DIST_SAME_POD
    if a.node != b.node:
        return DIST_SAME_RACK
    return DIST_SAME_NODE


@dataclasses.dataclass
class Topology:
    """A full cluster topology: ``pods`` data centers, each with ``racks``
    racks of ``nodes_per_rack`` nodes.

    The paper's testbed is 4 racks in 4 locations, 30 compute nodes each; the
    production TPU analogue is 2 pods x 16 "racks" (mesh rows) x 16 nodes.
    """

    pods: int = 1
    racks: int = 4
    nodes_per_rack: int = 30

    def all_addresses(self) -> List[NodeAddress]:
        return [
            NodeAddress(p, r, n)
            for p, r, n in itertools.product(
                range(self.pods), range(self.racks), range(self.nodes_per_rack)
            )
        ]

    @property
    def num_nodes(self) -> int:
        return self.pods * self.racks * self.nodes_per_rack

    def flat_index(self, addr: NodeAddress) -> int:
        return (addr.pod * self.racks + addr.rack) * self.nodes_per_rack + addr.node

    def address_of(self, flat: int) -> NodeAddress:
        node = flat % self.nodes_per_rack
        rack = (flat // self.nodes_per_rack) % self.racks
        pod = flat // (self.nodes_per_rack * self.racks)
        return NodeAddress(pod, rack, node)


def spread_choice(
    candidates: Sequence[NodeAddress],
    existing: Iterable[NodeAddress],
) -> NodeAddress:
    """Choose the candidate that maximizes topology spread from ``existing``.

    Paper §2.2: "The new location of the file copy is based on the topology of
    the slaves' network" — replicas should survive rack/pod failures, so we
    pick the candidate whose *minimum* distance to any existing replica is
    largest (ties broken deterministically by address for reproducibility).
    """
    existing = list(existing)
    if not candidates:
        raise ValueError("no candidate slaves for replica placement")
    if not existing:
        return min(candidates)

    def score(c: NodeAddress) -> tuple:
        dmin = min(distance(c, e) for e in existing)
        return (-dmin, c)

    return min(candidates, key=score)


def group_by_pod(addresses: Iterable[NodeAddress]) -> Dict[int, List[NodeAddress]]:
    out: Dict[int, List[NodeAddress]] = {}
    for a in addresses:
        out.setdefault(a.pod, []).append(a)
    return out
