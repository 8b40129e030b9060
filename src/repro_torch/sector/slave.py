"""Sector slave node (paper §2.1-2.2).

A slave stores Sector slices as *whole files* in its native filesystem — never
split into blocks. All metadata the system needs is therefore recoverable by
scanning the slave's data directory (``scan()``), which is how the master
rebuilds its index after a restart.

Slaves only accept commands from the master object; clients never touch a
slave directly (the master hands the client a slave reference for an
exclusive data connection, which here is the ``read_file``/``write_file``
call surface used by :class:`repro_torch.sector.client.SectorClient` under master
coordination).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
from typing import Dict, Optional

from repro_torch.sector.topology import NodeAddress


@dataclasses.dataclass
class LocalFileInfo:
    path: str          # sector path (e.g. "/sdss/SDSS1.dat")
    size: int
    md5: str


def _md5(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


class SlaveNode:
    """One storage node, backed by a real directory on the local filesystem."""

    def __init__(self, slave_id: int, address: NodeAddress, root: str, ip: str,
                 capacity_bytes: int = 1 << 40):
        self.slave_id = slave_id
        self.address = address
        self.root = root
        self.ip = ip
        self.capacity_bytes = capacity_bytes
        self.alive = True
        #: bumped on every restart — lets failure-detector audit logs tell
        #: one incarnation of a flapping node from the next.
        self.incarnation = 0
        #: number of in-flight services; the master prefers non-busy slaves.
        self.active_services = 0
        os.makedirs(root, exist_ok=True)

    # -- local path mapping ------------------------------------------------
    def _local(self, sector_path: str) -> str:
        rel = sector_path.lstrip("/")
        return os.path.join(self.root, rel)

    # -- storage primitives (master-coordinated) ---------------------------
    def write_file(self, sector_path: str, data: bytes) -> LocalFileInfo:
        if not self.alive:
            raise IOError(f"slave {self.slave_id} is down")
        if self.used_bytes() + len(data) > self.capacity_bytes:
            raise IOError(f"slave {self.slave_id} out of capacity")
        local = self._local(sector_path)
        os.makedirs(os.path.dirname(local), exist_ok=True)
        tmp = local + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, local)  # atomic publish, never a torn slice
        return LocalFileInfo(sector_path, len(data), _md5(data))

    def read_file(self, sector_path: str) -> bytes:
        if not self.alive:
            raise IOError(f"slave {self.slave_id} is down")
        with open(self._local(sector_path), "rb") as f:
            return f.read()

    def delete_file(self, sector_path: str) -> None:
        if not self.alive:
            raise IOError(f"slave {self.slave_id} is down")
        local = self._local(sector_path)
        if os.path.exists(local):
            os.remove(local)

    def has_file(self, sector_path: str) -> bool:
        return self.alive and os.path.exists(self._local(sector_path))

    # -- introspection ------------------------------------------------------
    def scan(self) -> Dict[str, LocalFileInfo]:
        """Recover all slice metadata by scanning the data directory.

        This is the paper's key argument for whole-file slices: the master can
        rebuild its entire index from slave scans alone.
        """
        if not self.alive:
            raise IOError(f"slave {self.slave_id} is down")
        out: Dict[str, LocalFileInfo] = {}
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for name in filenames:
                if name.endswith(".tmp"):
                    continue
                local = os.path.join(dirpath, name)
                sector_path = "/" + os.path.relpath(local, self.root).replace(os.sep, "/")
                with open(local, "rb") as f:
                    data = f.read()
                out[sector_path] = LocalFileInfo(sector_path, len(data), _md5(data))
        return out

    def used_bytes(self) -> int:
        total = 0
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for name in filenames:
                total += os.path.getsize(os.path.join(dirpath, name))
        return total

    def available_bytes(self) -> int:
        return self.capacity_bytes - self.used_bytes()

    # -- failure injection ----------------------------------------------------
    def drop_file(self, sector_path: str) -> None:
        """Silently lose one local file WITHOUT master coordination — the
        fault-injection twin of :meth:`delete_file`. Models bit-rot / a lost
        disk sector / a partially-failed move: the master's index still lists
        this slave as a replica holder, so the next coordinated read here
        fails and the data plane must recover (see
        :meth:`repro_torch.sector.master.Master.recover_file`)."""
        local = self._local(sector_path)
        if os.path.exists(local):
            os.remove(local)

    def kill(self, wipe: bool = False) -> None:
        """Simulate node failure. ``wipe=True`` models disk loss as well."""
        self.alive = False
        if wipe:
            shutil.rmtree(self.root, ignore_errors=True)
            os.makedirs(self.root, exist_ok=True)

    def restart(self) -> None:
        self.alive = True
        self.incarnation += 1
