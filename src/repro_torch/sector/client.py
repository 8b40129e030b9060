"""Sector client (paper §2.3-2.4).

A client logs on via the security server (through the master), then performs
uploads/downloads; every transfer is master-coordinated and served by a single
slave chosen for topology closeness and low load. Whole-file slices mean a
client touches exactly one slave per file (the paper's contrast with
block-based stores).
"""

from __future__ import annotations

import time
import zlib
from typing import Callable, List, Optional

from repro_torch.core.retry import RetryPolicy
from repro_torch.obs.metrics import MS_BUCKETS, REGISTRY
from repro_torch.sector.master import FileMeta, Master
from repro_torch.sector.topology import NodeAddress


class SectorClient:
    def __init__(self, master: Master, user: str, password: str,
                 client_ip: str = "10.0.0.1",
                 client_addr: Optional[NodeAddress] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 recover_attempts: int = 1,
                 sleep: Optional[Callable[[float], None]] = None):
        self.master = master
        self.client_addr = client_addr
        #: backoff between :meth:`recover` attempts; the default policy and
        #: ``recover_attempts=1`` keep the legacy fail-fast behaviour
        self.retry_policy = (RetryPolicy() if retry_policy is None
                             else retry_policy)
        self.recover_attempts = max(1, int(recover_attempts))
        self._sleep = time.sleep if sleep is None else sleep
        self._session = master.security.login(user, password, client_ip)

    @property
    def session_id(self) -> int:
        return self._session.session_id

    # -- file API ------------------------------------------------------------
    def upload(self, path: str, data: bytes) -> FileMeta:
        return self.master.upload(self.session_id, path, data, self.client_addr)

    def download(self, path: str) -> bytes:
        return self.master.download(self.session_id, path, self.client_addr)

    def delete(self, path: str) -> None:
        self.master.delete(self.session_id, path)

    def stat(self, path: str) -> Optional[FileMeta]:
        return self.master.lookup(path)

    def recover(self, path: str) -> FileMeta:
        """Mid-job recovery hook (paper §3.5.2): after a failed segment read,
        ask the master to prune stale replica locations, rediscover surviving
        copies by scan, and re-replicate the file back toward the replication
        factor.

        Retries up to ``recover_attempts`` times under ``retry_policy`` —
        a copy may come back mid-backoff (a rejoining slave) — recording
        each delay in the ``sector.recover.backoff_ms`` histogram. Raises
        IOError when every copy is still gone after the last attempt."""
        self.master.security.check_access(self.session_id, path, "r")
        key = zlib.crc32(path.encode())   # deterministic per-path jitter key
        for attempt in range(self.recover_attempts):
            try:
                return self.master.recover_file(path)
            except (IOError, OSError):
                if attempt + 1 >= self.recover_attempts:
                    raise
                d = self.retry_policy.delay(attempt, key=key)
                REGISTRY.histogram("sector.recover.backoff_ms",
                                   bounds=MS_BUCKETS).observe(d * 1e3)
                self._sleep(d)
        raise AssertionError("unreachable")

    def ls(self, prefix: str = "/") -> List[FileMeta]:
        return self.master.list_dir(prefix)

    def upload_dataset(self, prefix: str, slices: List[bytes]) -> List[FileMeta]:
        """Upload a dataset as numbered Sector slices (paper §2.1: 'datasets
        ... are divided into 1 or more separate files, which are called Sector
        Slices')."""
        out = []
        for i, data in enumerate(slices):
            out.append(self.upload(f"{prefix}.{i:05d}", data))
        return out

    def close(self) -> None:
        self.master.security.logout(self.session_id)
