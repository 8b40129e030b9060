"""Sector master server (paper §2.1-2.2).

The master maintains the metadata index (file -> size/checksum/locations),
tracks slave liveness/load/space, verifies slaves against the security
server's IP allow-list, coordinates every client-slave transfer, and runs the
*periodic* replication check: if a file has fewer than ``replication_factor``
live copies, a new copy is created on a topology-spread slave. Replication is
lazy/periodic — the paper's contrast with GFS/HDFS at-write replication, and
the reason Table 1 compares Hadoop at replication factors 1 and 3.

``block_mode`` emulates a Hadoop-style block-based store (files chunked into
fixed blocks, each block replicated independently) so the benchmarks can
compare against the paper's baseline design point.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.sector.security import AccessDenied, SecurityServer
from repro_torch.sector.slave import SlaveNode
from repro_torch.sector.topology import NodeAddress, distance, spread_choice


@dataclasses.dataclass
class FileMeta:
    path: str
    size: int
    md5: str
    #: slave ids currently holding a (believed-live) copy
    locations: Set[int]


class Master:
    """Metadata + coordination. One per deployment (the paper supports
    multiple masters sharing a security server; we model one)."""

    def __init__(
        self,
        security: SecurityServer,
        replication_factor: int = 3,
        block_mode: bool = False,
        block_size: int = 64 << 20,
    ) -> None:
        self.security = security
        self.replication_factor = replication_factor
        self.block_mode = block_mode
        self.block_size = block_size
        self.slaves: Dict[int, SlaveNode] = {}
        self.index: Dict[str, FileMeta] = {}
        self.stats = {"replications": 0, "lost_files": 0, "transfers": 0,
                      "recoveries": 0}
        #: the placement choice and the bookkeeping around each transfer
        #: (busy counts, the index, stats); transfers themselves run
        #: outside it, so that threads upload, download and replicate
        #: files side by side
        self._lock = threading.RLock()
        #: files a thread is copying to another slave now: another thread
        #: leaves them alone (see _replicate_once)
        self._copying: Set[str] = set()

    # -- slave membership ---------------------------------------------------
    def register_slave(self, slave: SlaveNode) -> None:
        """Admit a slave iff the security server allows its IP (paper §2.3)."""
        if not self.security.verify_slave(slave.ip):
            raise AccessDenied(f"slave ip {slave.ip} not on the allow-list")
        self.slaves[slave.slave_id] = slave
        # absorb anything already on its disk (scan-based metadata recovery)
        for path, info in slave.scan().items():
            meta = self.index.get(path)
            if meta is None:
                self.index[path] = FileMeta(path, info.size, info.md5, {slave.slave_id})
            else:
                meta.locations.add(slave.slave_id)

    def live_slaves(self) -> List[SlaveNode]:
        return [s for s in self.slaves.values() if s.alive]

    def mark_slave_down(self, slave_id: int) -> None:
        """Heartbeat loss (declared by a :class:`FailureDetector`): drop the
        slave from every file's location set."""
        for meta in self.metas():
            meta.locations.discard(slave_id)

    # -- metadata recovery ----------------------------------------------------
    def recover_from_scan(self) -> None:
        """Rebuild the entire index from slave directory scans (paper §2.2:
        'Sector can recover all the metadata it requires by simply scanning
        the data directories on each slave').

        Replica conflicts (same path, different md5) are resolved by
        *majority vote across all live holders*, not by scan order: the
        winning md5 is the one with the most holders, ties broken
        deterministically by the lexicographically smallest md5. Losing
        copies are deleted from their slaves."""
        self.index.clear()
        # two passes: collect every live scan first, THEN vote per path — a
        # single streaming pass would crown whichever copy was scanned first
        infos: Dict[int, Dict[str, "LocalFileInfo"]] = {
            sid: slave.scan() for sid, slave in self.slaves.items()
            if slave.alive}
        by_path: Dict[str, Dict[str, List[int]]] = {}
        for sid, scan in infos.items():
            for path, info in scan.items():
                by_path.setdefault(path, {}).setdefault(info.md5, []).append(sid)
        for path, groups in sorted(by_path.items()):
            win = min(groups, key=lambda md5: (-len(groups[md5]), md5))
            holders = groups[win]
            info = infos[holders[0]][path]
            self.index[path] = FileMeta(path, info.size, win, set(holders))
            for md5, sids in groups.items():
                if md5 != win:
                    for sid in sids:
                        self.slaves[sid].delete_file(path)

    # -- placement policy -----------------------------------------------------
    def _placement_candidates(self, size: int, exclude: Set[int]) -> List[SlaveNode]:
        return [
            s for s in self.live_slaves()
            if s.slave_id not in exclude and s.available_bytes() >= size
        ]

    def choose_upload_slave(self, size: int, client_addr: Optional[NodeAddress] = None
                            ) -> SlaveNode:
        """Pick the initial slave for an upload: close to the client, not busy,
        with space (paper: 'choose a slave ... close to the client and not
        busy with other services')."""
        cands = self._placement_candidates(size, exclude=set())
        if not cands:
            raise IOError("no slave with sufficient space")

        def key(s: SlaveNode) -> Tuple:
            d = distance(client_addr, s.address) if client_addr else 0
            return (d, s.active_services, -s.available_bytes(), s.slave_id)

        return min(cands, key=key)

    def choose_download_slave(self, path: str, client_addr: Optional[NodeAddress] = None
                              ) -> SlaveNode:
        meta = self._meta_or_raise(path)
        cands = [self.slaves[sid] for sid in meta.locations
                 if sid in self.slaves and self.slaves[sid].alive]
        if not cands:
            raise IOError(f"no live replica of {path}")

        def key(s: SlaveNode) -> Tuple:
            d = distance(client_addr, s.address) if client_addr else 0
            return (d, s.active_services, s.slave_id)

        return min(cands, key=key)

    # -- file operations (always master-coordinated) ----------------------------
    def _meta_or_raise(self, path: str) -> FileMeta:
        meta = self.index.get(path)
        if meta is None:
            raise FileNotFoundError(path)
        return meta

    def upload(self, session_id: int, path: str, data: bytes,
               client_addr: Optional[NodeAddress] = None) -> FileMeta:
        self.security.check_access(session_id, path, "w")
        if self.block_mode and len(data) > self.block_size:
            return self._upload_blocks(path, data, client_addr)
        with self._lock:
            slave = self.choose_upload_slave(len(data), client_addr)
            slave.active_services += 1
        try:
            info = slave.write_file(path, data)
        finally:
            with self._lock:
                slave.active_services -= 1
        meta = FileMeta(path, info.size, info.md5, {slave.slave_id})
        with self._lock:
            self.index[path] = meta
            self.stats["transfers"] += 1
        return meta

    def _upload_blocks(self, path: str, data: bytes,
                       client_addr: Optional[NodeAddress]) -> FileMeta:
        """Hadoop-style block-mode: chunk + replicate-at-write. The client must
        then touch many slaves to read the file back — the contrast the paper
        draws with whole-file slices."""
        first_meta: Optional[FileMeta] = None
        nblocks = (len(data) + self.block_size - 1) // self.block_size
        for b in range(nblocks):
            chunk = data[b * self.block_size:(b + 1) * self.block_size]
            bpath = f"{path}.blk{b:05d}"
            meta = None
            # replicate at write time (HDFS behaviour)
            exclude: Set[int] = set()
            for _copy in range(self.replication_factor):
                cands = self._placement_candidates(len(chunk), exclude)
                if not cands:
                    break
                existing = [self.slaves[s].address for s in exclude]
                addr = spread_choice([c.address for c in cands], existing)
                slave = next(c for c in cands if c.address == addr)
                info = slave.write_file(bpath, chunk)
                exclude.add(slave.slave_id)
                if meta is None:
                    meta = FileMeta(bpath, info.size, info.md5, set())
                meta.locations.add(slave.slave_id)
                self.stats["transfers"] += 1
            assert meta is not None
            self.index[bpath] = meta
            if first_meta is None:
                first_meta = meta
        manifest = FileMeta(path, len(data), "", set())
        self.index[path] = manifest
        return manifest

    def download(self, session_id: int, path: str,
                 client_addr: Optional[NodeAddress] = None) -> bytes:
        self.security.check_access(session_id, path, "r")
        meta = self._meta_or_raise(path)
        if self.block_mode and not meta.locations:  # block manifest
            nblocks = (meta.size + self.block_size - 1) // self.block_size
            parts = []
            for b in range(nblocks):
                parts.append(self._download_one(f"{path}.blk{b:05d}", client_addr))
            return b"".join(parts)
        return self._download_one(path, client_addr)

    def _download_one(self, path: str, client_addr: Optional[NodeAddress]) -> bytes:
        with self._lock:
            slave = self.choose_download_slave(path, client_addr)
            slave.active_services += 1
        try:
            data = slave.read_file(path)
        finally:
            with self._lock:
                slave.active_services -= 1
        with self._lock:
            self.stats["transfers"] += 1
        return data

    def delete(self, session_id: int, path: str) -> None:
        self.security.check_access(session_id, path, "w")
        meta = self._meta_or_raise(path)
        for sid in list(meta.locations):
            slave = self.slaves.get(sid)
            if slave is not None and slave.alive:
                slave.delete_file(path)
        del self.index[path]

    def lookup(self, path: str) -> Optional[FileMeta]:
        return self.index.get(path)

    def metas(self) -> List[FileMeta]:
        """The index's entries now, taken under the lock: threads may be
        adding files while the caller walks them."""
        with self._lock:
            return list(self.index.values())

    def list_dir(self, prefix: str) -> List[FileMeta]:
        with self._lock:
            items = sorted(self.index.items())
        return [m for p, m in items if p.startswith(prefix)]

    def locations_of(self, path: str) -> List[NodeAddress]:
        meta = self._meta_or_raise(path)
        return [self.slaves[s].address for s in sorted(meta.locations)
                if s in self.slaves and self.slaves[s].alive]

    # -- mid-job recovery -----------------------------------------------------
    def _live_holders(self, meta: FileMeta) -> List[int]:
        return [s for s in sorted(meta.locations)
                if s in self.slaves and self.slaves[s].alive
                and self.slaves[s].has_file(meta.path)]

    def _replicate_once(self, meta: FileMeta) -> bool:
        """Create at most one new topology-spread copy of ``meta`` from a
        live holder, while it has fewer live copies than the replication
        factor. Returns True iff a copy was made (False too while another
        thread copies the same file: a daemon pass beside a checkpoint's
        upload threads neither writes one copy twice nor one too many)."""
        with self._lock:
            if meta.path in self._copying:
                return False
            live = self._live_holders(meta)
            if not live or len(live) >= self.replication_factor:
                return False
            cands = self._placement_candidates(meta.size, exclude=set(live))
            if not cands:
                return False
            existing = [self.slaves[s].address for s in live]
            addr = spread_choice([c.address for c in cands], existing)
            dst = next(c for c in cands if c.address == addr)
            self._copying.add(meta.path)
        try:
            data = self.slaves[live[0]].read_file(meta.path)
            dst.write_file(meta.path, data)
        finally:
            with self._lock:
                self._copying.discard(meta.path)
        with self._lock:
            meta.locations.add(dst.slave_id)
            self.stats["replications"] += 1
        return True

    def replicate(self, path: str) -> int:
        """Bring one file up to the replication factor now, from a live
        holder, with topology-spread copies (what a daemon pass does for
        it); returns the copies made. A copy another thread is making is
        left to it."""
        meta = self._meta_or_raise(path)
        made = 0
        while (len(self._live_holders(meta)) < self.replication_factor
               and self._replicate_once(meta)):
            made += 1
        return made

    def learn(self, meta: FileMeta) -> None:
        """Index a file that another master's view of the same slaves
        wrote (its path, size, MD5 and holders): the entry a scan of
        those slaves would give, without reading the file."""
        self.index[meta.path] = FileMeta(meta.path, meta.size, meta.md5,
                                         set(meta.locations))

    def forget(self, path: str) -> None:
        """Drop a file from this view's index, its copies untouched:
        another view of the same slaves has deleted them."""
        self.index.pop(path, None)

    def recover_file(self, path: str) -> FileMeta:
        """Restore a file whose index locations went stale mid-job (paper
        §3.5.2 meets §2.2): prune locations that no longer actually hold the
        bytes, fall back to a directory scan of every live slave (the §2.2
        scan-based metadata recovery — a copy may survive on a slave the
        index lost track of), then re-replicate from a surviving copy back
        toward the replication factor. Raises IOError when no live copy
        exists anywhere (the data is truly lost)."""
        meta = self._meta_or_raise(path)
        good = set(self._live_holders(meta))
        if not good:
            good = {sid for sid, s in self.slaves.items()
                    if s.alive and s.has_file(path)}
        stale = meta.locations != good
        meta.locations = good
        if not good:
            self.stats["lost_files"] += 1
            raise IOError(f"no surviving replica of {path}")
        made = 0
        while (len(self._live_holders(meta)) < self.replication_factor
               and self._replicate_once(meta)):
            made += 1
        if stale or made:
            self.stats["recoveries"] += 1
        return meta


class FailureDetector:
    """Heartbeat-driven failure detection with an injectable clock.

    State machine per slave (documented in docs/ARCHITECTURE.md)::

        alive --no beat > suspect_after--> suspect
        suspect --no beat > down_after----> down      (locations pruned,
                                                       reported to the caller)
        down --beat resumes---------------> rejoined  (re-absorbed via the
                                                       §2.2 scan path, then
                                                       alive again)

    ``tick(now)`` is one detection pass: polling ``slave.alive`` stands in
    for "a heartbeat message arrived since the last tick" — every state
    decision is made from the recorded per-slave last-heartbeat timestamp
    against ``now``, never from the flag itself, so detection latency is an
    explicit, clock-injected property (virtual clocks in tests, wall time in
    production). A gap exceeding ``down_after`` outright skips the suspect
    hop. Returns the list of slave ids newly declared down this pass.

    This replaces the retired manual ``Master.heartbeat_sweep``: an
    *instant* detector (``suspect_after=down_after=0``) reproduces it
    exactly, which is what :class:`ReplicationDaemon` builds when not handed
    a shared detector.
    """

    ALIVE, SUSPECT, DOWN = "alive", "suspect", "down"

    def __init__(self, master: Master, suspect_after: float = 5.0,
                 down_after: float = 15.0, clock=time.time):
        if down_after < suspect_after:
            raise ValueError(
                f"down_after ({down_after}) must be >= suspect_after "
                f"({suspect_after})")
        self.master = master
        self.suspect_after = suspect_after
        self.down_after = down_after
        self.clock = clock
        self.last_beat: Dict[int, float] = {}
        self.state: Dict[int, str] = {}
        #: human-readable transition log (mirrors the chaos audit-log style)
        self.events: List[str] = []
        self.stats = {"suspected": 0, "downed": 0, "rejoined": 0}

    def believes_alive(self, slave_id: int) -> bool:
        """The detector's *belief* — suspect still counts as alive (lazy
        replication must not storm on a transient); only ``down`` does not.
        A slave never yet observed falls back to its actual flag."""
        st = self.state.get(slave_id)
        if st is None:
            s = self.master.slaves.get(slave_id)
            return s is not None and s.alive
        return st != self.DOWN

    def tick(self, now: Optional[float] = None) -> List[int]:
        now = self.clock() if now is None else now
        newly_down: List[int] = []
        for sid in sorted(self.master.slaves):
            slave = self.master.slaves[sid]
            st = self.state.get(sid, self.ALIVE)
            if slave.alive:
                self.last_beat[sid] = now
                if st == self.DOWN:
                    # rejoin: re-absorb surviving slices via the §2.2 scan
                    self.master.register_slave(slave)
                    self.stats["rejoined"] += 1
                    self.events.append(
                        f"t={now:g}: slave {sid} rejoined (incarnation "
                        f"{slave.incarnation}); re-absorbed by scan")
                elif st == self.SUSPECT:
                    self.events.append(
                        f"t={now:g}: slave {sid} cleared suspicion")
                self.state[sid] = self.ALIVE
                continue
            # no heartbeat this pass: judge the silence by its age alone
            age = now - self.last_beat.get(sid, -math.inf)
            if st != self.DOWN and age > self.down_after:
                self.state[sid] = self.DOWN
                self.master.mark_slave_down(sid)
                self.stats["downed"] += 1
                newly_down.append(sid)
                self.events.append(
                    f"t={now:g}: slave {sid} down "
                    f"(no heartbeat for {age:g}s)")
            elif st == self.ALIVE and age > self.suspect_after:
                self.state[sid] = self.SUSPECT
                self.stats["suspected"] += 1
                self.events.append(
                    f"t={now:g}: slave {sid} suspected "
                    f"(no heartbeat for {age:g}s)")
        return newly_down


class ReplicationDaemon:
    """Periodic replication check (paper §2.2): for every under-replicated
    file, create a new copy on a topology-spread slave. Run ``tick()`` from
    the training loop / tests; ``run_until_stable()`` iterates to fixpoint.

    ``period`` rate-limits ordinary ticks (the paper's replication is lazy
    and *periodic*, which is what keeps a flapping slave from triggering a
    re-replication storm): a tick arriving sooner than ``period`` seconds
    after the last effective one is a no-op. ``period=0`` keeps the old
    always-run behaviour; ``clock`` is injectable for tests.

    Liveness comes from a :class:`FailureDetector`, ticked at the start of
    every effective pass, and replica counting follows the detector's
    *belief*: a silent-but-not-yet-down slave's copies still count, so the
    daemon never storms ahead of detection. When no detector is passed the
    daemon builds an instant one (``suspect_after=down_after=0``), which
    reproduces the retired manual ``heartbeat_sweep`` exactly.
    """

    def __init__(self, master: Master, period: float = 0.0, clock=time.time,
                 detector: Optional[FailureDetector] = None):
        self.master = master
        self.period = period
        self.clock = clock
        if detector is None:
            detector = FailureDetector(master, suspect_after=0.0,
                                       down_after=0.0, clock=clock)
        self.detector = detector
        self._last: Optional[float] = None

    def under_replicated(self) -> List[FileMeta]:
        m = self.master
        det = self.detector
        return [
            meta for meta in m.metas()
            if meta.locations and
            len([s for s in meta.locations
                 if det.believes_alive(s)]) < m.replication_factor
        ]

    def tick(self, max_copies: int = 1 << 30, force: bool = False) -> int:
        """One replication pass; returns the number of new copies created.

        Honors ``period`` unless ``force``: a call inside the quiet window
        does nothing (and does not reset the window)."""
        if (not force and self.period > 0 and self._last is not None
                and self.clock() - self._last < self.period):
            return 0
        self._last = self.clock()
        m = self.master
        self.detector.tick()
        created = 0
        for meta in self.under_replicated():
            if created >= max_copies:
                break
            live = [s for s in meta.locations
                    if self.detector.believes_alive(s)]
            if not live:
                m.stats["lost_files"] += 1
                continue
            if m._replicate_once(meta):
                created += 1
        return created

    def run_until_stable(self, max_rounds: int = 64) -> int:
        total = 0
        for _ in range(max_rounds):
            made = self.tick(force=True)
            total += made
            if made == 0:
                break
        return total
