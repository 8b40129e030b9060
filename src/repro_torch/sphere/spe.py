"""Sphere Processing Engine (paper §3.3).

Port of ``repro/sphere/spe.py``. The SPE loop, verbatim from the paper:

  1. accept a new data segment (file name, offset, rows, params);
  2. read the segment (+ its .idx index) from local disk or another slave;
  3. run the processing function on records / groups / the whole segment,
     writing results to the proper destinations, with periodic progress acks;
  4. ack segment completion; release when the client closes.

Here an SPE fetches a segment's bytes through the Sector master (host
bytes: Sector is a host file system), moves them to the executor's device
in one copy, and runs the UDF over tensors there (locality is the
scheduler's job). ``result`` is returned to the client (engine) or routed
to bucket files via the engine's bucket writer — including the paper's
local-dump-first fault-tolerance contract.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.comm import resolve_device
from repro_torch.core.records import RecordCodec
from repro_torch.core.stream import SegmentInfo
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sector.master import Master
from repro_torch.sector.topology import NodeAddress


class SegmentLost(IOError):
    """The SPE itself is healthy but its input segment could not be fetched
    from Sector (every listed replica dead or missing). Distinguished from a
    plain IOError (SPE crash) so the engine blames the *data*, not the
    worker: the SPE stays in the pool and the engine triggers
    ``SectorClient.recover`` before re-pooling the segment (§3.5.2)."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"segment input {path} lost: {reason}")
        self.path = path


def _to_device(block: np.ndarray, device: Any) -> torch.Tensor:
    """One copy of a host byte block onto ``device``. The block views the
    immutable bytes Sector returned: on the CPU it is copied (a UDF may
    write in place); for the card the read-only view is the copy's source.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return torch.from_numpy(block.copy())
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(block).to(dev)


@dataclasses.dataclass
class SPE:
    spe_id: int
    address: NodeAddress
    master: Master
    session_id: int
    #: injected failure: raise IOError after this many segments (None = never)
    fail_after: Optional[int] = None
    segments_done: int = 0

    def read_segment(self, seg: SegmentInfo, record_bytes: int) -> np.ndarray:
        """Step 2: fetch the segment's bytes (whole-file slice + offset),
        as a host ``(n, record_bytes)`` uint8 array."""
        try:
            data = self.master.download(self.session_id, seg.file_path,
                                        client_addr=self.address)
        except (FileNotFoundError, IOError, OSError) as e:
            raise SegmentLost(seg.file_path, repr(e)) from e
        start = seg.offset * record_bytes
        stop = start + seg.num_records * record_bytes
        chunk = data[start:stop]
        return np.frombuffer(chunk, dtype=np.uint8).reshape(
            seg.num_records, record_bytes)

    def process(self, seg: SegmentInfo, udf: Callable[[Any], Any],
                record_bytes: int,
                codec: Optional[RecordCodec] = None,
                trace: Optional[Any] = None,
                device: Any = None) -> Any:
        """Steps 1-4 for one segment.

        The segment's bytes go to ``device`` (``cuda`` unless the caller
        passes ``"cpu"``) in one host-to-device copy of the ``(n,
        record_bytes)`` uint8 block; with a ``codec`` the SPE
        unpacks them there into the structured record tree before invoking
        the UDF — the schema travels with the shipped UDF, mirroring the
        paper's ``.idx``-indexed record files. Without one the UDF gets the
        uint8 block. With a ``trace`` the read (fetch, copy, decode) and
        UDF phases become ``spe.read`` / ``spe.udf`` sub-spans of the
        engine's segment span."""
        tr = trace if trace is not None else NULL_TRACER
        if self.fail_after is not None and self.segments_done >= self.fail_after:
            raise IOError(f"SPE {self.spe_id} crashed")
        with tr.span("spe.read", path=seg.file_path,
                     records=seg.num_records):
            records = _to_device(self.read_segment(seg, record_bytes),
                                 device)
            if codec is not None:
                records = codec.unpack(records)
        with tr.span("spe.udf"):
            result = udf(records)
        self.segments_done += 1
        return result
