"""Deterministic fault injection for Sphere dataflows.

Port of ``repro/sphere/chaos.py``. A :class:`FaultPlan` describes one
failure — which kind, at which phase boundary or stream batch, against
which victim — and the executors consult it at every boundary; a
:class:`ChaosSchedule` is an ordered, seeded sequence of them sharing one
audit log. Both are framework-free and copied from the reference line for
line: the seed mix and the schedule's re-derivation choose the same victim
slave, bucket and rank, and the events logs match the reference's word for
word.

Fault kinds and the recovery path each exercises:

``kill_slave``   (HostExecutor / streaming) — a storage node dies
    (optionally with its disk) and every SPE co-located with it crashes
    on its next segment: master rerouting, §3.5.2 segment re-pooling and
    the replication daemon.
``drop_bucket``  (HostExecutor) — one input file of the target phase is
    dropped from every listed holder while one unlisted copy survives: the
    §2.2 scan in ``SectorClient.recover`` finds and re-replicates it.
``lose_device``  (SPMDExecutor / streaming) — one rank of the grid is lost
    at a hop boundary: the executor re-forms the largest usable smaller
    grid (:func:`repro_torch.train.elastic.shrink_mesh`), re-stacks the
    boundary's :class:`HopCheckpoint` onto it and resumes the hop.
``rejoin_slave`` (HostExecutor / streaming) — a killed slave restarts and
    is re-absorbed by the §2.2 scan path.
``lose_batch``   (StreamExecutor) — the in-flight micro-batch is lost; its
    tickets requeue (exactly once).
``none``         — no fault; with ``SPMDExecutor.run(chaos=...)`` it still
    forces the segmented per-hop path.

A lost rank's memory is gone, so a :class:`HopCheckpoint` lives in host
memory: the records packed on the device into the codec's byte rows
(:meth:`~repro_torch.core.records.RecordCodec.pack`, the layout of
``encode``) and brought to the host in one copy, plus ``valid``. A
:class:`StreamCheckpoint`'s durable bytes equal the reference's for the
same carry and tickets.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import Ranks
from repro_torch.core.records import (RecordCodec, tree_flatten,
                                      tree_unflatten)

HOST_KINDS = ("kill_slave", "drop_bucket", "rejoin_slave")
SPMD_KINDS = ("lose_device",)
STREAM_KINDS = ("lose_batch",)
KINDS = ("none",) + HOST_KINDS + SPMD_KINDS + STREAM_KINDS


def plan_kinds(chaos: Any) -> Tuple[str, ...]:
    """The fault kinds a plan or schedule can fire — the executors' guard
    rails accept either a :class:`FaultPlan` (``.kind``) or a
    :class:`ChaosSchedule` (``.kinds``)."""
    kinds = getattr(chaos, "kinds", None)
    if kinds is not None:
        return tuple(kinds)
    return (chaos.kind,)


@dataclasses.dataclass
class FaultPlan:
    """One injected failure, fully determined by its fields + ``seed``.

    ``phase`` is the phase-boundary index at which the fault fires:
    boundary ``b`` is *before* phase ``b`` runs (0 = before the first
    phase, i.e. against the source files / initial shards; 1 = between the
    first and second phase — "between stage A and stage B").

    ``victim`` pins the target (slave id for ``kill_slave``/``rejoin_slave``,
    global device index for ``lose_device``); ``path`` pins the file for
    ``drop_bucket``. When unset, the target is drawn from a
    ``random.Random(seed)`` over the *sorted* candidate set — deterministic
    per (plan, deployment).

    ``at_batch`` arms the fault at a StreamExecutor micro-batch boundary
    instead of a phase boundary: batch ``b`` means *before* micro-batch
    ``b`` is dispatched. Batch-armed faults are fired via
    :meth:`fire_stream` (normally through a :class:`ChaosSchedule` given to
    ``StreamExecutor(chaos=...)``) and are ignored by the batch executors'
    ``fire_host`` / ``fire_spmd``.
    """

    kind: str = "none"
    phase: int = 1
    victim: Optional[int] = None
    path: Optional[str] = None
    #: ``kill_slave``: also lose the disk (the harsher variant)
    wipe: bool = True
    seed: int = 0
    #: arm at a stream micro-batch index instead of a phase boundary
    at_batch: Optional[int] = None
    fired: bool = dataclasses.field(default=False, init=False)
    #: human-readable audit log of what was actually broken
    events: List[str] = dataclasses.field(default_factory=list, init=False)

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")

    def _rng(self) -> random.Random:
        # integer mix, NOT hash(tuple): str hashes vary per-process with
        # PYTHONHASHSEED, and a chaos plan must replay identically anywhere
        mix = 0
        batch = -1 if self.at_batch is None else self.at_batch
        for part in (self.seed, KINDS.index(self.kind), self.phase, batch):
            mix = mix * 1000003 + part
        return random.Random(mix)

    # -- host (Sector/SPE) faults -------------------------------------------
    def fire_host(self, boundary: int, master, paths: Sequence[str],
                  spes: Sequence[Any] = ()) -> bool:
        """Called by :class:`~repro_torch.sphere.dataflow.HostExecutor` at every
        phase boundary with that phase's input ``paths``. Injects the fault
        iff this is the armed boundary; returns whether it fired."""
        if (self.fired or self.at_batch is not None
                or boundary != self.phase or self.kind not in HOST_KINDS):
            return False
        self._fire_host_kind(f"boundary {boundary}", master, paths, spes)
        self.fired = True
        return True

    def _fire_host_kind(self, label: str, master, paths: Sequence[str],
                        spes: Sequence[Any]) -> None:
        if self.kind == "kill_slave":
            self._kill_slave(label, master, paths, spes)
        elif self.kind == "rejoin_slave":
            self._rejoin_slave(label, master)
        else:
            self._drop_bucket(label, master, paths)

    def _kill_slave(self, label: str, master, paths: Sequence[str],
                    spes: Sequence[Any]) -> None:
        if self.victim is not None:
            slave = master.slaves[self.victim]
        else:
            holders = set()
            for p in paths:
                meta = master.lookup(p)
                if meta is not None:
                    holders |= meta.locations
            cands = [master.slaves[s] for s in sorted(holders)
                     if s in master.slaves and master.slaves[s].alive]
            if not cands:
                cands = sorted(master.live_slaves(), key=lambda s: s.slave_id)
            if not cands:
                raise RuntimeError("kill_slave: no live slave to kill")
            slave = self._rng().choice(cands)
        slave.kill(wipe=self.wipe)
        crashed = []
        for spe in spes:
            if spe.address == slave.address:
                # its next segment raises IOError -> engine re-pools (§3.5.2)
                spe.fail_after = spe.segments_done
                crashed.append(spe.spe_id)
        self.events.append(
            f"{label}: killed slave {slave.slave_id} "
            f"at {slave.address}{' (disk wiped)' if self.wipe else ''}; "
            f"crashed SPEs {crashed}")

    def _rejoin_slave(self, label: str, master) -> None:
        if self.victim is not None:
            slave = master.slaves[self.victim]
        else:
            dead = sorted((s for s in master.slaves.values() if not s.alive),
                          key=lambda s: s.slave_id)
            if not dead:
                raise RuntimeError("rejoin_slave: no dead slave to rejoin")
            slave = self._rng().choice(dead)
        slave.restart()
        # the §2.2 scan path re-absorbs whatever survived on its disk; a
        # FailureDetector, if one is watching, also re-registers on the
        # slave's next heartbeat — both are idempotent
        master.register_slave(slave)
        self.events.append(
            f"{label}: slave {slave.slave_id} rejoined at {slave.address} "
            f"(incarnation {slave.incarnation}); "
            f"re-absorbed {len(slave.scan())} files by scan")

    def _drop_bucket(self, label: str, master, paths: Sequence[str]) -> None:
        cands = []
        for p in sorted(set(paths)):
            meta = master.lookup(p)
            if meta is None:
                continue
            if any(s in master.slaves and master.slaves[s].has_file(p)
                   for s in meta.locations):
                cands.append(p)
        if self.path is not None:
            path = self.path
        elif cands:
            path = self._rng().choice(cands)
        else:
            raise RuntimeError("drop_bucket: no input file with a live copy")
        meta = master.lookup(path)
        holders = [s for s in sorted(meta.locations)
                   if s in master.slaves and master.slaves[s].has_file(path)]
        data = master.slaves[holders[0]].read_file(path)
        # stash one survivor copy on a slave the index does NOT list, writing
        # slave-to-slave behind the master's back: the index is now fully
        # stale and only the §2.2 scan in recover_file can find the bytes
        hide = [s for s in master.live_slaves()
                if s.slave_id not in meta.locations
                and s.available_bytes() >= meta.size]
        hide.sort(key=lambda s: s.slave_id)
        keep: Optional[int] = None
        if hide:
            stash = self._rng().choice(hide)
            stash.write_file(path, data)
            where = f"stashed unlisted copy on slave {stash.slave_id}"
        else:
            # every live slave is a listed holder: keep one, drop the rest —
            # the index is still stale (pruned holders) and recovery must run
            keep = holders[-1]
            where = f"kept only listed copy on slave {keep}"
        for sid in holders:
            if sid != keep:
                master.slaves[sid].drop_file(path)
        self.events.append(
            f"{label}: dropped {path} from listed holders "
            f"{[s for s in holders if s != keep]}; {where}")

    # -- SPMD (device) faults -------------------------------------------------
    def fire_spmd(self, boundary: int, num_devices: int) -> Optional[int]:
        """Called by the SPMD executor at every hop boundary. Returns the
        global index of the lost device when the fault fires, else None."""
        if (self.fired or self.at_batch is not None
                or boundary != self.phase or self.kind not in SPMD_KINDS):
            return None
        lost = self._pick_device(num_devices)
        self.fired = True
        self.events.append(
            f"boundary {boundary}: lost device {lost}/{num_devices}")
        return lost

    def _pick_device(self, num_devices: int) -> int:
        lost = (self.victim if self.victim is not None
                else self._rng().randrange(num_devices))
        if not 0 <= lost < num_devices:
            raise ValueError(f"victim device {lost} out of range {num_devices}")
        return lost

    # -- stream (micro-batch boundary) faults ---------------------------------
    def fire_stream(self, batch: int, *, master: Any = None,
                    paths: Sequence[str] = (),
                    num_devices: Optional[int] = None) -> Optional[Any]:
        """Called by :class:`~repro_torch.sphere.streaming.StreamExecutor` at every
        micro-batch boundary (normally via
        :meth:`ChaosSchedule.due_at_batch`). Fires iff this fault is armed at
        batch index ``batch``. Returns the lost device index for
        ``lose_device``, ``True`` for every other kind that fired, ``None``
        when not due.

        Host kinds need the stream's attached Sector deployment (``master``;
        ``paths`` are the stream's durable checkpoint files, the only Sector
        state a pure stream owns)."""
        if self.fired or self.at_batch != batch or self.kind == "none":
            return None
        label = f"batch {batch}"
        if self.kind in SPMD_KINDS:
            if num_devices is None:
                raise ValueError("lose_device needs num_devices")
            lost = self._pick_device(num_devices)
            self.fired = True
            self.events.append(f"{label}: lost device {lost}/{num_devices}")
            return lost
        if self.kind in HOST_KINDS:
            if master is None:
                raise ValueError(
                    f"{self.kind!r} at a batch boundary needs an attached "
                    f"Sector deployment (StreamExecutor.attach_sector)")
            self._fire_host_kind(label, master, paths, spes=())
            self.fired = True
            return True
        # lose_batch: the executor requeues the in-flight tickets
        self.fired = True
        self.events.append(f"{label}: lost in-flight micro-batch")
        return True


class ChaosSchedule:
    """An ordered, seeded sequence of :class:`FaultPlan` faults.

    Every member's seed is re-derived from ``(schedule seed, position, its
    own seed)`` with the same integer mix the plans use, and all members
    share ONE ``events`` audit log — so a multi-fault run carries the same
    deterministic-replay guarantee as a single plan: same schedule + same
    deployment => byte-identical events, in firing order.

    A schedule is a drop-in for a single plan on the batch executors
    (``fire_host`` / ``fire_spmd`` delegate to every *phase-armed* member);
    batch-armed members (``at_batch=``) are consumed by ``StreamExecutor``
    via :meth:`due_at_batch`.
    """

    def __init__(self, faults: Sequence[FaultPlan], seed: int = 0):
        self.seed = seed
        self.faults: List[FaultPlan] = list(faults)
        self.events: List[str] = []
        for i, f in enumerate(self.faults):
            f.seed = (seed * 1000003 + i) * 1000003 + f.seed
            f.events = self.events    # shared, ordered audit log

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(f.kind for f in self.faults)

    @property
    def fired(self) -> bool:
        """True once every member has fired."""
        return all(f.fired for f in self.faults)

    @property
    def fired_count(self) -> int:
        return sum(f.fired for f in self.faults)

    def due_at_batch(self, batch: int) -> List[FaultPlan]:
        """Unfired members armed at stream batch index ``batch``, in order."""
        return [f for f in self.faults
                if not f.fired and f.at_batch == batch]

    def fire_host(self, boundary: int, master, paths: Sequence[str],
                  spes: Sequence[Any] = ()) -> bool:
        fired = False
        for f in self.faults:
            fired = f.fire_host(boundary, master, paths, spes) or fired
        return fired

    def fire_spmd(self, boundary: int, num_devices: int) -> Optional[int]:
        for f in self.faults:
            lost = f.fire_spmd(boundary, num_devices)
            if lost is not None:
                return lost
        return None

    def __repr__(self) -> str:
        arms = [f"{f.kind}@{'batch ' + str(f.at_batch) if f.at_batch is not None else 'phase ' + str(f.phase)}"
                for f in self.faults]
        return f"ChaosSchedule(seed={self.seed}, faults=[{', '.join(arms)}])"


@dataclasses.dataclass
class HopCheckpoint:
    """State of a dataflow at a hop boundary, as layout-agnostic host
    bytes: the records packed into ``(N, nbytes)`` uint8 rows (the exact
    on-wire/on-disk layout of :class:`RecordCodec`), rank-major, plus the
    ``(N,)`` validity mask. Because rows are rank-major and a shrunken
    grid's extent divides the old one (:func:`~repro_torch.train.elastic.
    shrink_mesh`), every old rank's rows land whole on one new rank at
    restore — reduce groups and bucket segments are never split, which is
    what makes resume multiset-exact."""

    codec: RecordCodec
    payload: np.ndarray    # (N, codec.nbytes) uint8
    valid: np.ndarray      # (N,) bool
    hop: int
    dropped: int

    @classmethod
    def snapshot(cls, records: Any, valid: Any, hop: int,
                 dropped: int) -> "HopCheckpoint":
        """``records``: a tree of tensors or arrays whose leaves lead with
        ``valid``'s axes — ``(ranks, n)`` stacked or ``(N,)`` rows. Packed
        where they lie (on the card for the executors) and copied to the
        host once."""
        leaves, treedef = tree_flatten(records)
        if isinstance(valid, torch.Tensor):
            batch_dims = valid.dim()
            valid_h = valid.reshape(-1).to("cpu", torch.bool, copy=True).numpy()
        else:
            valid_h = np.asarray(valid)
            batch_dims = valid_h.ndim
            valid_h = valid_h.reshape(-1).astype(bool)
        codec = RecordCodec.from_example(records, batch_dims=batch_dims)
        if isinstance(leaves[0], torch.Tensor):
            payload = codec.pack(records).reshape(-1, codec.nbytes)
            payload = payload.cpu().numpy()
        else:
            rows = [np.asarray(a).reshape((-1,) + np.shape(a)[batch_dims:])
                    for a in leaves]
            payload = codec.encode(tree_unflatten(treedef, rows))
        return cls(codec=codec, payload=payload, valid=valid_h, hop=hop,
                   dropped=int(dropped))

    def restore(self, ranks: Ranks, axes: Sequence[str]) -> Tuple[Any, Any]:
        """Back onto ``ranks``' device in one copy of the rows, unpacked
        there and re-stacked by :func:`~repro_torch.train.elastic.remesh`;
        returns ``(records, valid)``, each leaf ``(world, N / world,
        ...)``, ready to resume hop ``hop``."""
        from repro_torch.train import elastic

        axes = tuple(axes)
        if tuple(ranks.axes) != axes:
            raise ValueError(f"restore onto axes {axes} of a grid with "
                             f"axes {ranks.axes}")
        # copy=True: on the CPU too, the restored records own their memory
        rows = torch.from_numpy(self.payload).to(ranks.device, copy=True)
        valid = torch.from_numpy(self.valid).to(ranks.device, copy=True)
        records, valid = elastic.remesh((rows, valid), ranks)
        return self.codec.unpack(records), valid


@dataclasses.dataclass
class StreamCheckpoint:
    """Stream state sealed at a micro-batch boundary: the carry buffer plus
    the in-flight ticket ids of the batch about to be dispatched.

    The carry travels as a :class:`HopCheckpoint` over the FULL padded carry
    buffer (valid and invalid rows alike): the executor keeps the carry's
    global row count constant across a grid shrink, so restoring onto any
    survivor grid whose extent divides the old one lands every old rank's
    carry whole on the new rank that owns its buckets.

    ``to_bytes``/``from_bytes`` give the checkpoint a byte-deterministic
    durable form for upload into Sector (flat dict-of-array records only),
    byte-identical to the JAX package's for the same carry and tickets.
    """

    step: int
    ticket_ids: Tuple[int, ...]
    carry: Optional[HopCheckpoint]

    MAGIC = b"SCKP1\n"

    @classmethod
    def seal(cls, step: int, tickets: Sequence[Any],
             carry: Optional[Tuple[Any, Any]]) -> "StreamCheckpoint":
        """Seal the boundary before dispatching ``tickets``: ``carry`` is the
        executor's ``(records, valid)`` padded carry pair (or None before the
        first stateful batch)."""
        hc = None
        if carry is not None:
            records, valid = carry
            hc = HopCheckpoint.snapshot(records, valid, hop=int(step),
                                        dropped=0)
        return cls(step=int(step),
                   ticket_ids=tuple(t.req_id for t in tickets), carry=hc)

    def restore_carry(self, ranks: Ranks,
                      axes: Sequence[str]) -> Optional[Tuple[Any, Any]]:
        """Re-stack the padded carry onto ``ranks`` (e.g. the survivor grid
        after ``lose_device``); None when the stream had no carry yet."""
        if self.carry is None:
            return None
        return self.carry.restore(ranks, axes)

    def to_bytes(self) -> bytes:
        """Byte-deterministic serialization (no timestamps): MAGIC, an
        8-byte little-endian header length, a JSON header, then the raw
        array buffers in header order."""
        header: dict = {"step": self.step, "tickets": list(self.ticket_ids),
                        "carry": self.carry is not None}
        blobs: List[bytes] = []
        if self.carry is not None:
            recs = self.carry.codec.decode(self.carry.payload)
            if not (isinstance(recs, dict)
                    and all(isinstance(v, np.ndarray) for v in recs.values())):
                raise TypeError(
                    "StreamCheckpoint durability needs flat dict-of-array "
                    f"records, got {tree_flatten(recs)[1]}")
            header["hop"] = self.carry.hop
            header["dropped"] = self.carry.dropped
            fields = []
            for name in sorted(recs):
                a = np.ascontiguousarray(recs[name])
                fields.append([name, a.dtype.str, list(a.shape)])
                blobs.append(a.tobytes())
            valid = np.ascontiguousarray(self.carry.valid)
            fields.append(["__valid__", valid.dtype.str, list(valid.shape)])
            blobs.append(valid.tobytes())
            header["fields"] = fields
        head = json.dumps(header, sort_keys=True).encode()
        out = [self.MAGIC, len(head).to_bytes(8, "little"), head]
        out.extend(blobs)
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "StreamCheckpoint":
        if not data.startswith(cls.MAGIC):
            raise ValueError("not a StreamCheckpoint byte stream")
        off = len(cls.MAGIC)
        hlen = int.from_bytes(data[off:off + 8], "little")
        off += 8
        header = json.loads(data[off:off + hlen].decode())
        off += hlen
        carry = None
        if header["carry"]:
            arrays = {}
            for name, dtype, shape in header["fields"]:
                n = int(np.prod(shape)) if shape else 1
                nbytes = n * np.dtype(dtype).itemsize
                arrays[name] = np.frombuffer(
                    data[off:off + nbytes], dtype=dtype).reshape(shape)
                off += nbytes
            valid = arrays.pop("__valid__")
            carry = HopCheckpoint.snapshot(arrays, valid, hop=header["hop"],
                                           dropped=header["dropped"])
        return cls(step=header["step"], ticket_ids=tuple(header["tickets"]),
                   carry=carry)
