"""sphere_shuffle: the flat bucket shuffle (paper §3.2), stacked ranks.

Port of the flat path of ``repro/core/shuffle.py``. Buckets are assigned
contiguously to ranks; each rank

1. frames every local record into one byte row (payload + the metadata
   this hop needs — :class:`repro_torch.core.records.WireFrame`),
2. runs the fused O(n) partition/pack
   (:func:`repro_torch.kernels.ops.partition_pack`, kernel K1 on the card),
3. exchanges exactly **one** ``(ranks, capacity+1, row_bytes)`` uint8 tile
   stack per hop (:meth:`repro_torch.comm.Ranks.all_to_all`), with one
   int32 count per tile in a header row carrying slot validity.

With ``chunks > 1`` the local stream splits into W chunks of capacity
``ceil(capacity / W)``, one exchange each. Records past capacity are
dropped and counted (the §3.5.1 segment clamp).

Every function takes rank-stacked tensors: the JAX function's per-device
``(n, ...)`` arrays become ``(ranks, n, ...)``, and each stage runs once
over all ranks. The hierarchical (dc, node) path, ``combine`` and
``wan_profile`` are not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.comm import Ranks
from repro_torch.core.records import WireFrame
from repro_torch.kernels import ops as kops

#: wire_meta modes: which per-record metadata rides in the frame rows.
WIRE_META_MODES = ("full", "bucket", "min")
_WIRE_META_FLAT = {"full": ("bucket", "src"), "bucket": ("bucket",),
                   "min": ()}


@dataclasses.dataclass
class ShuffleResult:
    """Per-rank view of a completed shuffle, stacked over ranks.

    data:    (ranks, num_src, slots, *rec) records received, grouped by
             source rank. With ``chunks=W``, ``slots = W * ceil(capacity/W)``.
    valid:   (ranks, num_src, slots) bool.
    bucket:  (ranks, num_src, slots) int32 global bucket id (-1 where
             invalid), or None unless ``wire_meta`` ships it.
    src_pos: (ranks, num_src, slots) int32 row at the source, or None
             unless ``wire_meta="full"``.
    dropped: () int32 — records dropped over all ranks (capacity overflow).
    """

    data: torch.Tensor
    valid: torch.Tensor
    bucket: Optional[torch.Tensor]
    src_pos: Optional[torch.Tensor]
    dropped: torch.Tensor


#: hop-geometry sink (see :func:`record_hops`).
_HOP_SINK: Optional[List[dict]] = None


@contextlib.contextmanager
def record_hops(sink: List[dict]):
    """Collect one dict per shuffle hop run inside the ``with`` block
    (wire bytes per rank, chunk rounds, destinations)."""
    global _HOP_SINK
    prev = _HOP_SINK
    _HOP_SINK = sink
    try:
        yield sink
    finally:
        _HOP_SINK = prev


def _wire_exchange(frame: WireFrame, payload: torch.Tensor,
                   meta: Dict[str, torch.Tensor], dest: torch.Tensor,
                   num_dest: int, capacity: int, chunks: int, ranks: Ranks):
    """One hop: frame -> chunked partition/pack -> ONE all_to_all per chunk
    -> open. ``payload``/``dest`` lead with ``(ranks, n)``. Returns
    (payload, valid, metas, dropped per rank) with receive shape
    ``(ranks, num_dest, chunks * ceil(capacity / chunks))``."""
    framed = frame.frame_rows(payload, **meta)          # (R, n, row)
    r, n = framed.shape[:2]
    w = max(int(chunks), 1)
    cap_c = -(-capacity // w)
    if _HOP_SINK is not None:
        _HOP_SINK.append({
            "axis": "ranks", "num_dest": num_dest, "capacity": capacity,
            "chunks": w, "row_nbytes": frame.row_nbytes,
            "tile_nbytes": frame.tile_nbytes(cap_c),
            "wire_bytes_per_device": w * num_dest * frame.tile_nbytes(cap_c),
            "meta": list(frame.meta),
        })
    nc = -(-n // w) if n else 0
    if w * nc != n:  # pad the stream so chunks are equal-shaped; padding
        pad = w * nc - n  # rows route to the virtual overflow destination
        framed = torch.cat([framed, framed.new_zeros((r, pad, frame.row_nbytes))],
                           dim=1)
        dest = torch.cat([dest, dest.new_full((r, pad), num_dest)], dim=1)
    parts = []
    dropped = torch.zeros((r,), dtype=torch.int32, device=framed.device)
    for k in range(w):
        rows = framed[:, k * nc:(k + 1) * nc]
        dk = dest[:, k * nc:(k + 1) * nc]
        (tile,), in_rng, _, drop_k = kops.partition_pack([rows], dk, num_dest,
                                                         cap_c)
        # empty slots hold a duplicated row-0 gather — zero them so the
        # wire is deterministic and no local bytes leak across ranks
        tile *= in_rng[..., None].to(torch.uint8)
        counts = in_rng.sum(dim=-1, dtype=torch.int32)
        parts.append(frame.open(ranks.all_to_all(frame.seal(tile, counts))))
        dropped += drop_k
    if w == 1:
        pay, val, metas = parts[0]
    else:
        pay = torch.cat([p[0] for p in parts], dim=2)
        val = torch.cat([p[1] for p in parts], dim=2)
        metas = {name: torch.cat([p[2][name] for p in parts], dim=2)
                 for name in frame.meta}
    return pay, val, metas, dropped


def _masked(metas: Dict[str, torch.Tensor], name: str,
            valid: torch.Tensor) -> Optional[torch.Tensor]:
    if name not in metas:
        return None
    return torch.where(valid, metas[name], -1)


def sphere_shuffle(data: torch.Tensor, bucket_ids: torch.Tensor,
                   num_buckets: int, capacity: int, ranks: Ranks,
                   valid: Optional[torch.Tensor] = None, chunks: int = 1,
                   wire_meta: str = "full") -> ShuffleResult:
    """Send each record to the rank owning its bucket (flat path).

    ``num_buckets`` must be a multiple of the rank count; bucket b lives on
    rank ``b // (num_buckets // ranks)``.

    Args:
      data: (ranks, n, *rec) local records of every rank.
      bucket_ids: (ranks, n) int32 in [0, num_buckets); out-of-range ids
        (e.g. -1 for padding) are not sent.
      capacity: max records any source sends to any one destination (split
        ~evenly across ``chunks``).
      valid: optional (ranks, n) bool marking real input records.
      chunks: pipeline depth W.
      wire_meta: which metadata to ship per record (``WIRE_META_MODES``).
    """
    world = ranks.world
    if num_buckets % world != 0:
        raise ValueError(f"num_buckets={num_buckets} not divisible by "
                         f"{world} ranks")
    if wire_meta not in WIRE_META_MODES:
        raise ValueError(f"wire_meta={wire_meta!r} not in {WIRE_META_MODES}")
    bpd = num_buckets // world
    ids = bucket_ids.to(torch.int32)
    ok = (ids >= 0) & (ids < num_buckets)
    if valid is not None:
        ok &= valid
    # invalid records get dest = world (a virtual overflow destination)
    dest = torch.where(ok, torch.div(ids, bpd, rounding_mode="floor"),
                       world).to(torch.int32)
    names = _WIRE_META_FLAT[wire_meta]
    frame = WireFrame.for_payload(data, meta=names, batch_dims=2)
    meta = {}
    if "bucket" in names:
        meta["bucket"] = ids
    if "src" in names:
        meta["src"] = torch.arange(data.shape[1], dtype=torch.int32,
                                   device=data.device).expand(world, -1)
    pay, val, metas, drop = _wire_exchange(frame, data, meta, dest, world,
                                           capacity, chunks, ranks)
    return ShuffleResult(data=pay, valid=val,
                         bucket=_masked(metas, "bucket", val),
                         src_pos=_masked(metas, "src", val),
                         dropped=ranks.psum(drop))


@dataclasses.dataclass(frozen=True)
class ShufflePlan:
    """A flat shuffle strategy over ``world`` ranks: per-tile capacity and
    pipeline depth ``chunks``. Built host-side from static shapes."""

    num_buckets: int
    world: int
    capacity: int
    chunks: int = 1

    def __post_init__(self):
        if self.num_buckets % self.world != 0:
            raise ValueError(f"num_buckets={self.num_buckets} not divisible "
                             f"by {self.world} ranks")
        if self.chunks < 1:
            raise ValueError(f"chunks={self.chunks} must be >= 1")

    @property
    def buckets_per_device(self) -> int:
        return self.num_buckets // self.world

    @property
    def stage_slots(self) -> int:
        """Receive slots per source: ``chunks * ceil(capacity / chunks)``."""
        return self.chunks * (-(-self.capacity // self.chunks))

    @property
    def recv_slots(self) -> int:
        """Rows of one rank's receive buffer."""
        return self.world * self.stage_slots

    @classmethod
    def for_ranks(cls, ranks: Ranks, num_buckets: int, n_local: int,
                  capacity_factor: float = 2.0,
                  chunks: int = 1) -> "ShufflePlan":
        """Capacity sized for ``n_local`` records per rank at uniform load,
        padded by ``capacity_factor`` (the §3.5.1 segment clamp)."""
        cap = int(n_local / ranks.world * capacity_factor) + 1
        return cls(num_buckets, ranks.world, cap, chunks)

    def device_index(self, ranks: Ranks) -> torch.Tensor:
        """(ranks,) int32 rank ids in bucket-ownership order."""
        return ranks.axis_index()

    def shuffle(self, ranks: Ranks, data: torch.Tensor,
                bucket_ids: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                wire_meta: str = "full") -> ShuffleResult:
        if ranks.world != self.world:
            raise ValueError(f"plan is for {self.world} ranks, got "
                             f"{ranks.world}")
        return sphere_shuffle(data, bucket_ids, self.num_buckets,
                              self.capacity, ranks, valid=valid,
                              chunks=self.chunks, wire_meta=wire_meta)
