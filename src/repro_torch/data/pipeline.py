"""Training data pipeline on the Sector/Sphere substrate.

Port of ``repro/data/pipeline.py`` (a copy: framework-free, imports
changed). Datasets are token arrays stored as Sector slices (int32
little-endian, whole-file per slice). Batches are assembled per *host*
following the Sphere scheduler: segments are assigned with the locality
rules (:meth:`SegmentScheduler.static_assignment`), reads go through the
master so replica choice/failover is automatic, and a host that dies
mid-epoch simply has its remaining segments re-assigned (the paper's
SPE-timeout semantics, exercised in the tests via ``reassign_lost``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.stream import SegmentInfo, SphereStream
from repro_torch.sector.client import SectorClient
from repro_torch.sector.master import Master
from repro_torch.sphere.scheduler import SegmentScheduler, SPEState

RECORD_BYTES = 4  # one int32 token


def upload_token_dataset(client: SectorClient, prefix: str,
                         tokens: np.ndarray, num_slices: int = 8):
    """Store a token corpus as Sector slices (paper §2.1: a dataset is 1+
    files; e.g. the 1.3 TB / 64-file SDSS set)."""
    tokens = tokens.astype(np.int32)
    per = (len(tokens) + num_slices - 1) // num_slices
    metas = []
    for i in range(num_slices):
        chunk = tokens[i * per:(i + 1) * per]
        metas.append(client.upload(f"{prefix}.{i:05d}", chunk.tobytes()))
    return metas


class SectorDataPipeline:
    """Iterates (tokens, labels) batches for one host group.

    ``host_addr``/``host_id``: which SPE this pipeline feeds; with
    ``num_hosts`` > 1 the segment table is partitioned by the scheduler's
    locality-greedy static assignment.
    """

    def __init__(self, master: Master, client: SectorClient, prefix: str,
                 batch: int, seq_len: int, host_id: int = 0,
                 num_hosts: int = 1, seed: int = 0,
                 segment_records: int = 1 << 16):
        self.master = master
        self.client = client
        self.batch = batch
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)

        files = [(m.path, m.size // RECORD_BYTES)
                 for m in master.list_dir(prefix)
                 if not m.path.endswith("MANIFEST.json")]
        if not files:
            raise FileNotFoundError(f"no dataset slices under {prefix}")
        total = sum(n for _, n in files)
        self.segments = SphereStream.plan_segments(
            total, RECORD_BYTES, files,
            s_min=RECORD_BYTES, s_max=segment_records * RECORD_BYTES,
            num_spes=num_hosts * 4)

        # locality-aware host assignment (Sphere rules 1-3)
        spes = [SPEState(i, list(master.slaves.values())[
            i % max(len(master.slaves), 1)].address)
            for i in range(num_hosts)]
        locations = {p: master.locations_of(p) for p, _ in files}
        sched = SegmentScheduler(self.segments, spes, locations)
        assignment = sched.static_assignment()
        self.my_segments: List[SegmentInfo] = [
            self.segments[i] for i in assignment.get(host_id, [])]
        self._buffer = np.zeros((0,), np.int32)
        self._cursor = 0

    def _read_segment(self, seg: SegmentInfo) -> np.ndarray:
        data = self.client.download(seg.file_path)
        arr = np.frombuffer(data, np.int32)
        return arr[seg.offset:seg.offset + seg.num_records]

    def reassign_lost(self, lost_segment_indices: Sequence[int]) -> None:
        """Fold segments from a dead host back into this host's queue."""
        self.my_segments.extend(self.segments[i] for i in lost_segment_indices)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self.rng.permutation(len(self.my_segments))
        need = self.batch * (self.seq_len + 1)
        for si in order:
            seg = self.my_segments[si]
            self._buffer = np.concatenate([self._buffer,
                                           self._read_segment(seg)])
            while len(self._buffer) >= need:
                chunk = self._buffer[:need]
                self._buffer = self._buffer[need:]
                block = chunk.reshape(self.batch, self.seq_len + 1)
                yield {"tokens": block[:, :-1].copy(),
                       "labels": block[:, 1:].copy()}
