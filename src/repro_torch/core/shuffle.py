"""sphere_shuffle: the bucket shuffle (paper §3.2), stacked ranks.

Port of ``repro/core/shuffle.py``. Buckets are assigned contiguously to
ranks; each rank

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

Wide-area (two-level) form — paper §2.2. Over a ``(dc, node)`` grid of
ranks, :func:`hierarchical_shuffle` runs

  Stage A  an exchange along ``node`` that groups records by destination
           DC and stages each on its final owner's node-row;
  Stage B  an exchange along ``dc``: one dense tile per remote DC per rank
           crosses the WAN (1/nodes of the flat path's tile count);
  Stage C  nothing: stage A already staged every record on its owner's
           node-row, so arrival is delivery.

:func:`sphere_combine` and :func:`hierarchical_combine` route per-record
results back to their origin rows. Collective counts per call
(``all_to_all``, at ``chunks=1``): flat shuffle 1, hierarchical shuffle 2,
flat combine 1, hierarchical combine 2; ``chunks=W`` multiplies the
shuffle counts by W. :class:`ShufflePlan` picks the path from its axes.

Every function takes rank-stacked tensors: the JAX function's per-device
``(n, ...)`` arrays become ``(ranks, n, ...)``, and each stage runs once
over all ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.comm import Ranks
from repro_torch.core.records import WireFrame
from repro_torch.kernels import ops as kops

#: wire_meta modes: which per-record metadata rides in the frame rows.
#: "full" — bucket + src (+ the stage-A position on the hierarchical path):
#: the complete ShuffleResult contract incl. combine; "bucket" — bucket
#: only; "min" — nothing beyond routing (the hierarchical stage A still
#: carries the bucket to route stage B).
WIRE_META_MODES = ("full", "bucket", "min")
_WIRE_META_FLAT = {"full": ("bucket", "src"), "bucket": ("bucket",),
                   "min": ()}
_WIRE_META_HIER = {"full": ("bucket", "src", "pos"), "bucket": ("bucket",),
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
    dropped: () int32 — records dropped over the exchange's ranks
             (capacity overflow); ``(ranks,)``, each rank its group's sum,
             when the exchange runs along some axes of the grid only.
    """

    data: torch.Tensor
    valid: torch.Tensor
    bucket: Optional[torch.Tensor]
    src_pos: Optional[torch.Tensor]
    dropped: torch.Tensor


@dataclasses.dataclass
class HierShuffleResult(ShuffleResult):
    """Result of :func:`hierarchical_shuffle`: the :class:`ShuffleResult`
    contract with ``num_src = dcs`` (row g holds the records relayed through
    DC g's staging rank on this rank's node-row; ``src_pos`` is still the
    record's row at its *origin* rank). The private fields thread the
    two-stage route back for :func:`hierarchical_combine` (None unless
    ``wire_meta="full"``)."""

    a_valid: torch.Tensor = None  # (ranks, nodes, slots_a) stage-A validity
    a_src: torch.Tensor = None    # (ranks, nodes, slots_a) stage-A origin rows
    b_pos: torch.Tensor = None    # (ranks, dcs, slots_b) row into stage A


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
                   num_dest: int, capacity: int, chunks: int, ranks: Ranks,
                   axis: Optional[str]):
    """One hop along ``axis``: frame -> chunked partition/pack -> ONE
    all_to_all per chunk -> open. ``payload``/``dest`` lead with ``(ranks,
    n)``. Returns (payload, valid, metas, dropped per rank) with receive
    shape ``(ranks, num_dest, chunks * ceil(capacity / chunks))``."""
    framed = frame.frame_rows(payload, **meta)          # (R, n, row)
    r, n = framed.shape[:2]
    w = max(int(chunks), 1)
    cap_c = -(-capacity // w)
    if _HOP_SINK is not None:
        _HOP_SINK.append({
            "axis": axis or "/".join(ranks.axes), "num_dest": num_dest,
            "capacity": capacity, "chunks": w,
            "row_nbytes": frame.row_nbytes,
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
    # each buffer is dropped as soon as the next one exists, so a hop holds
    # at most the framed rows and two tile stacks at once
    pending = [(framed[:, k * nc:(k + 1) * nc], dest[:, k * nc:(k + 1) * nc])
               for k in range(w)]
    del framed, dest
    for k in range(w):
        rows, dk = pending[k]
        pending[k] = None
        (tile,), in_rng, _, drop_k = kops.partition_pack([rows], dk, num_dest,
                                                         cap_c)
        del rows, dk
        # empty slots hold a duplicated row-0 gather — zero them so the
        # wire is deterministic and no local bytes leak across ranks
        tile *= in_rng[..., None].to(torch.uint8)
        sealed = frame.seal(tile, in_rng.sum(dim=-1, dtype=torch.int32))
        del tile, in_rng
        wire = ranks.all_to_all(sealed, axis)
        del sealed
        parts.append(frame.open(wire))
        del wire
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


def _arange_rows(ranks: Ranks, n: int, device) -> torch.Tensor:
    """``(ranks, n)`` int32 local row index of every record."""
    return torch.arange(n, dtype=torch.int32,
                        device=device).expand(ranks.rows, -1)


def sphere_shuffle(data: torch.Tensor, bucket_ids: torch.Tensor,
                   num_buckets: int, capacity: int, ranks: Ranks,
                   valid: Optional[torch.Tensor] = None, chunks: int = 1,
                   wire_meta: str = "full",
                   axis: Optional[str] = None) -> ShuffleResult:
    """Send each record to the rank owning its bucket along ``axis`` (flat
    path; None exchanges over every rank as one axis).

    ``num_buckets`` must be a multiple of the axis size D; bucket b lives at
    index ``b // (num_buckets // D)`` along the axis.

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
    size = ranks.axis_size(axis)
    if num_buckets % size != 0:
        raise ValueError(f"num_buckets={num_buckets} not divisible by "
                         f"{size} ranks")
    if wire_meta not in WIRE_META_MODES:
        raise ValueError(f"wire_meta={wire_meta!r} not in {WIRE_META_MODES}")
    bpd = num_buckets // size
    ids = bucket_ids.to(torch.int32)
    ok = (ids >= 0) & (ids < num_buckets)
    if valid is not None:
        ok &= valid
    # invalid records get dest = size (a virtual overflow destination)
    dest = torch.where(ok, torch.div(ids, bpd, rounding_mode="floor"),
                       size).to(torch.int32)
    names = _WIRE_META_FLAT[wire_meta]
    frame = WireFrame.for_payload(data, meta=names, batch_dims=2)
    meta = {}
    if "bucket" in names:
        meta["bucket"] = ids
    if "src" in names:
        meta["src"] = _arange_rows(ranks, data.shape[1], data.device)
    pay, val, metas, drop = _wire_exchange(frame, data, meta, dest, size,
                                           capacity, chunks, ranks, axis)
    return ShuffleResult(data=pay, valid=val,
                         bucket=_masked(metas, "bucket", val),
                         src_pos=_masked(metas, "src", val),
                         dropped=ranks.psum(drop, axis))


def hierarchical_shuffle(data: torch.Tensor, bucket_ids: torch.Tensor,
                         num_buckets: int, capacity_a: int, capacity_b: int,
                         ranks: Ranks, dc_axis: str = "dc",
                         node_axis: str = "node",
                         valid: Optional[torch.Tensor] = None,
                         chunks: int = 1,
                         wire_meta: str = "full") -> HierShuffleResult:
    """Two-level wide-area shuffle over a ``(dc, node)`` grid of ranks (see
    the module docstring).

    Bucket ownership matches the flat layout on the row-major rank order:
    bucket b lives on rank ``b // bpd`` = ``(dc, node) = (b // bpd //
    nodes, b // bpd % nodes)``.

    Args:
      data / bucket_ids / valid: as for :func:`sphere_shuffle`.
      capacity_a: stage-A tile size — max records one rank sends to one
        sibling inside its DC (≈ n_local / nodes × capacity_factor).
      capacity_b: stage-B (WAN) tile size — max staged records one rank
        sends to one remote DC (≈ n_local / dcs × capacity_factor).
      chunks / wire_meta: as for :func:`sphere_shuffle` (both stages chunk;
        stage A always carries the bucket — stage B routes by it).
    """
    dcs = ranks.axis_size(dc_axis)
    nodes = ranks.axis_size(node_axis)
    num_devices = dcs * nodes
    if num_devices != ranks.world:
        raise ValueError(f"axes ({dc_axis}, {node_axis}) cover {num_devices} "
                         f"of {ranks.world} ranks")
    if num_buckets % num_devices != 0:
        raise ValueError(f"num_buckets={num_buckets} not divisible by "
                         f"grid {dcs}x{nodes}")
    if wire_meta not in WIRE_META_MODES:
        raise ValueError(f"wire_meta={wire_meta!r} not in {WIRE_META_MODES}")
    bpd = num_buckets // num_devices
    world, n = bucket_ids.shape[:2]
    rec = tuple(data.shape[2:])

    ids = bucket_ids.to(torch.int32)
    ok = (ids >= 0) & (ids < num_buckets)
    if valid is not None:
        ok &= valid
    owner = torch.where(ok, torch.div(ids, bpd, rounding_mode="floor"), 0)

    # Stage A: exchange along node, keyed by the owner's node-row. The
    # bucket always rides along — stage B routes by it.
    names_b = _WIRE_META_HIER[wire_meta]
    names_a = ("bucket",) + (("src",) if "src" in names_b else ())
    frame_a = WireFrame.for_payload(data, meta=names_a, batch_dims=2)
    meta_a = {"bucket": ids}
    if "src" in names_a:
        meta_a["src"] = _arange_rows(ranks, n, data.device)
    dest_a = torch.where(ok, owner % nodes, nodes).to(torch.int32)
    pay_a, val_a, metas_a, drop_a = _wire_exchange(
        frame_a, data, meta_a, dest_a, nodes, capacity_a, chunks, ranks,
        node_axis)

    # Stage B: exchange along dc — the only WAN traffic. The staged rows
    # are stage A's receive buffer flattened per rank, (R, nodes * slots_a);
    # their destination DC comes from the shipped bucket, not the sender.
    n_staged = val_a.shape[1] * val_a.shape[2]
    f_pay = pay_a.reshape((world, n_staged) + rec)
    del pay_a
    f_valid = val_a.reshape(world, n_staged)
    f_bucket = metas_a["bucket"].reshape(world, n_staged)
    owner_b = torch.div(torch.where(f_valid, f_bucket, 0), bpd,
                        rounding_mode="floor")
    dest_b = torch.where(f_valid, torch.div(owner_b, nodes,
                                            rounding_mode="floor"),
                         dcs).to(torch.int32)
    frame_b = WireFrame.for_payload(data, meta=names_b, batch_dims=2)
    meta_b = {}
    if "bucket" in names_b:
        meta_b["bucket"] = f_bucket
    if "src" in names_b:
        meta_b["src"] = metas_a["src"].reshape(world, n_staged)
    if "pos" in names_b:
        meta_b["pos"] = _arange_rows(ranks, n_staged, data.device)
    pay_b, val_b, metas_b, drop_b = _wire_exchange(
        frame_b, f_pay, meta_b, dest_b, dcs, capacity_b, chunks, ranks,
        dc_axis)
    del f_pay

    # Stage C (fan-out inside the destination DC) is free: stage A staged
    # every record on its final owner's node-row, so stage B delivered it.
    return HierShuffleResult(
        data=pay_b, valid=val_b,
        bucket=_masked(metas_b, "bucket", val_b),
        src_pos=_masked(metas_b, "src", val_b),
        dropped=ranks.psum(drop_a + drop_b, (dc_axis, node_axis)),
        a_valid=val_a, a_src=_masked(metas_a, "src", val_a),
        b_pos=_masked(metas_b, "pos", val_b),
    )


def _scatter_add_rows(values: torch.Tensor, idx: torch.Tensor,
                      valid: torch.Tensor, out_rows: int) -> torch.Tensor:
    """Per rank, add ``values[r, j]`` into row ``idx[r, j]`` of a zeroed
    ``(ranks, out_rows, ...)``; invalid entries and indices outside
    ``[0, out_rows)`` land in one extra overflow row per rank that is cut
    off (``.at[idx].add(mode="drop")`` of the JAX package). On the card
    ``index_add_`` adds floats in no fixed order."""
    world, m = idx.shape
    tail = tuple(values.shape[2:])
    keep = valid & (idx >= 0) & (idx < out_rows)
    slot = torch.where(keep, idx.to(torch.int64), out_rows)
    slot = slot + torch.arange(world, dtype=torch.int64,
                               device=idx.device)[:, None] * (out_rows + 1)
    masked = values * keep.reshape(keep.shape + (1,) * len(tail)).to(
        values.dtype)
    out = torch.zeros((world * (out_rows + 1),) + tail, dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, slot.reshape(-1), masked.reshape((world * m,) + tail))
    return out.reshape((world, out_rows + 1) + tail)[:, :out_rows]


def sphere_combine(processed: torch.Tensor, shuffle: ShuffleResult,
                   num_local_out: int, ranks: Ranks,
                   axis: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route per-record results back to their source ranks and original
    rows (the inverse shuffle) along ``axis`` — ONE all_to_all: results,
    validity and return rows travel in one explicit-valid wire frame.
    ``processed`` must be ``(ranks, num_src, slots, *out)`` aligned with
    ``shuffle.data``, and the shuffle must have run with
    ``wire_meta="full"``. Results for the same source row are summed (the
    MoE top-k combine contract); integer results are exact, float results
    on the card are summed in no fixed order.

    Returns (combined ``(ranks, num_local_out, *out)``, hit_count
    ``(ranks, num_local_out)`` int32).
    """
    if shuffle.src_pos is None:
        raise ValueError("combine needs a shuffle run with wire_meta='full' "
                         "(src_pos was not shipped)")
    world, num_src, cap = processed.shape[:3]
    out_tail = tuple(processed.shape[3:])
    flat_p = processed.reshape((world, num_src * cap) + out_tail)
    frame = WireFrame.for_payload(flat_p, meta=("src",), explicit_valid=True,
                                  batch_dims=2)
    rows = frame.frame_rows(flat_p, valid=shuffle.valid.reshape(world, -1),
                            src=shuffle.src_pos.reshape(world, -1))
    back = ranks.all_to_all(rows.reshape(world, num_src, cap,
                                         frame.row_nbytes), axis)
    pay, bvalid, metas = frame.open_rows(back)
    flat = pay.reshape((world, num_src * cap) + out_tail)
    fvalid = bvalid.reshape(world, -1)
    fsrc = metas["src"].reshape(world, -1)
    combined = _scatter_add_rows(flat, fsrc, fvalid, num_local_out)
    hits = _scatter_add_rows(fvalid.to(torch.int32), fsrc, fvalid,
                             num_local_out)
    return combined, hits


def hierarchical_combine(processed: torch.Tensor, shuffle: HierShuffleResult,
                         num_local_out: int, ranks: Ranks,
                         dc_axis: str = "dc", node_axis: str = "node"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`hierarchical_shuffle`: results ride the WAN back to
    their staging rank (reverse stage B, ONE all_to_all along ``dc``), are
    scattered into the stage-A receive layout, then :func:`sphere_combine`
    reverses stage A back to the origin rows (one more, along ``node``).
    ``processed`` must be ``(ranks, dcs, slots_b, *out)`` aligned with
    ``shuffle.data``."""
    if shuffle.b_pos is None:
        raise ValueError("combine needs a shuffle run with wire_meta='full' "
                         "(b_pos was not shipped)")
    world, num_src, cap = processed.shape[:3]
    out_tail = tuple(processed.shape[3:])
    flat_p = processed.reshape((world, num_src * cap) + out_tail)
    frame = WireFrame.for_payload(flat_p, meta=("pos",), explicit_valid=True,
                                  batch_dims=2)
    rows = frame.frame_rows(flat_p, valid=shuffle.valid.reshape(world, -1),
                            pos=shuffle.b_pos.reshape(world, -1))
    back = ranks.all_to_all(rows.reshape(world, num_src, cap,
                                         frame.row_nbytes), dc_axis)
    pay, bvalid, metas = frame.open_rows(back)
    flat = pay.reshape((world, num_src * cap) + out_tail)
    fvalid = bvalid.reshape(world, -1)
    fpos = metas["pos"].reshape(world, -1)
    a_shape = tuple(shuffle.a_valid.shape[1:])          # (nodes, slots_a)
    n_staged = math.prod(a_shape)
    buf = _scatter_add_rows(flat, fpos, fvalid, n_staged)
    buf = buf.reshape((world,) + a_shape + out_tail)
    # records that survived stage A but were dropped at stage B got no
    # result back — mask them out so hit_count keeps the flat-path
    # contract (hits == 0 for undelivered records)
    delivered = _scatter_add_rows(fvalid.to(torch.int32), fpos, fvalid,
                                  n_staged) > 0
    a_valid = shuffle.a_valid & delivered.reshape((world,) + a_shape)
    synth = ShuffleResult(data=buf, valid=a_valid, bucket=None,
                          src_pos=shuffle.a_src,
                          dropped=torch.zeros((), dtype=torch.int32,
                                              device=buf.device))
    return sphere_combine(buf, synth, num_local_out, ranks, axis=node_axis)


# -- topology-parameterized plan -----------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShufflePlan:
    """A shuffle strategy: which rank axes to exchange over, with what
    per-tile capacities. One axis → the flat all_to_all; two axes ``(dc,
    node)`` → the two-level hierarchical path. ``chunks`` sets the pipeline
    depth W of every hop (see :func:`sphere_shuffle`).

    The JAX plan's ``use_pallas`` field has no counterpart: in the port the
    tensors' device decides between the Hopper kernels (CUDA) and their
    plain versions (CPU).
    """

    num_buckets: int
    axes: Tuple[str, ...]        # ("data",) flat, or (dc_axis, node_axis)
    shape: Tuple[int, ...]       # ranks along each axis
    capacities: Tuple[int, ...]  # (capacity,) or (capacity_a, capacity_b)
    chunks: int = 1

    def __post_init__(self):
        if len(self.axes) not in (1, 2) or len(self.axes) != len(self.shape):
            raise ValueError(f"bad plan axes={self.axes} shape={self.shape}")
        if len(self.capacities) != len(self.axes):
            raise ValueError("need one capacity per shuffle stage")
        if self.num_buckets % self.num_devices != 0:
            raise ValueError(f"num_buckets={self.num_buckets} not divisible "
                             f"by {self.num_devices} ranks")
        if self.chunks < 1:
            raise ValueError(f"chunks={self.chunks} must be >= 1")

    # -- static geometry ------------------------------------------------------
    @property
    def hierarchical(self) -> bool:
        return len(self.axes) == 2

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    @property
    def buckets_per_device(self) -> int:
        return self.num_buckets // self.num_devices

    def stage_slots(self, stage: int) -> int:
        """Receive slots per source for shuffle stage ``stage``:
        ``chunks * ceil(capacity / chunks)``."""
        cap = self.capacities[stage]
        return self.chunks * (-(-cap // self.chunks))

    @property
    def recv_slots(self) -> int:
        """Rows of one rank's receive buffer (= num_src * slots of the
        delivering stage)."""
        if self.hierarchical:
            return self.shape[0] * self.stage_slots(1)
        return self.shape[0] * self.stage_slots(0)

    # -- constructors ---------------------------------------------------------
    @classmethod
    def for_ranks(cls, ranks: Ranks, num_buckets: int, n_local: int,
                  capacity_factor: float = 2.0,
                  axes: Optional[Sequence[str]] = None,
                  chunks: int = 1) -> "ShufflePlan":
        """Capacities sized for ``n_local`` records per rank at uniform load,
        padded by ``capacity_factor`` (the §3.5.1 segment clamp). ``axes``
        defaults to every axis of ``ranks``."""
        axes = ranks.axes if axes is None else tuple(axes)
        shape = tuple(ranks.axis_size(a) for a in axes)
        if len(axes) == 1:
            caps = (int(n_local / shape[0] * capacity_factor) + 1,)
        else:
            dcs, nodes = shape
            caps = (int(n_local / nodes * capacity_factor) + 1,
                    int(n_local / dcs * capacity_factor) + 1)
        return cls(num_buckets, axes, shape, caps, chunks)

    @classmethod
    def from_topology(cls, topo, num_buckets: int, n_local: int,
                      capacity_factor: float = 2.0,
                      dc_axis: str = "dc", node_axis: str = "node",
                      chunks: int = 1) -> "ShufflePlan":
        """Map a :class:`repro_torch.sector.topology.Topology` onto a plan:
        pods become the WAN axis, racks × nodes_per_rack the intra-DC axis.
        A single-pod topology degenerates to the flat path."""
        nodes = topo.racks * topo.nodes_per_rack
        if topo.pods == 1:
            caps = (int(n_local / nodes * capacity_factor) + 1,)
            return cls(num_buckets, (node_axis,), (nodes,), caps, chunks)
        caps = (int(n_local / nodes * capacity_factor) + 1,
                int(n_local / topo.pods * capacity_factor) + 1)
        return cls(num_buckets, (dc_axis, node_axis), (topo.pods, nodes),
                   caps, chunks)

    # -- stacked-rank ops -----------------------------------------------------
    def check(self, ranks: Ranks) -> None:
        """Raise unless ``ranks`` has this plan's axes at its sizes. Ranks
        along other axes run the plan side by side, as the devices of a
        mesh axis the JAX plan does not name (the ``data`` rows of an
        expert-parallel MoE); executors that need the plan to cover every
        rank check that themselves."""
        for a, s in zip(self.axes, self.shape):
            if a not in ranks.axes or ranks.axis_size(a) != s:
                raise ValueError(f"plan axis {a}={s} does not match {ranks!r}")

    def device_index(self, ranks: Ranks) -> torch.Tensor:
        """``(ranks,)`` int32 rank index in bucket-ownership order."""
        return ranks.axis_index(self.axes)

    def pmean_axes(self) -> Tuple[str, ...]:
        return self.axes

    def shuffle(self, ranks: Ranks, data: torch.Tensor,
                bucket_ids: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                wire_meta: str = "full") -> ShuffleResult:
        self.check(ranks)
        if self.hierarchical:
            return hierarchical_shuffle(
                data, bucket_ids, self.num_buckets, self.capacities[0],
                self.capacities[1], ranks, self.axes[0], self.axes[1],
                valid=valid, chunks=self.chunks, wire_meta=wire_meta)
        return sphere_shuffle(data, bucket_ids, self.num_buckets,
                              self.capacities[0], ranks, valid=valid,
                              chunks=self.chunks, wire_meta=wire_meta,
                              axis=self.axes[0])

    def combine(self, ranks: Ranks, processed: torch.Tensor,
                result: ShuffleResult, num_local_out: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        self.check(ranks)
        if self.hierarchical:
            return hierarchical_combine(processed, result, num_local_out,
                                        ranks, self.axes[0], self.axes[1])
        return sphere_combine(processed, result, num_local_out, ranks,
                              axis=self.axes[0])

    # -- WAN cost model (host-side) -------------------------------------------
    def wan_profile(self, dcs: int, nodes: int, rec_bytes: int,
                    wire_segment_records: Optional[int] = None,
                    wire_meta: str = "full") -> dict:
        """Per-rank, per-round cross-DC traffic of this plan mapped onto a
        ``dcs × nodes`` wide-area layout (flat plans flatten it row-major).

        wan_tiles: fixed-capacity tiles shipped across a DC boundary —
          flat: one per remote *rank*; hierarchical: one per remote *DC*.
        wan_rounds: chunked exchange rounds (= ``chunks``).
        wan_slot_bytes: payload bytes the all_to_all ships over the WAN
          (tiles × capacity slots × rec_bytes, full even when half-empty).
        wan_frame_bytes: bytes of the one-tensor wire layout actually
          shipped — framed rows (payload + the ``wire_meta`` metadata ints)
          plus one count-header row per tile per round.
        wan_legacy_bytes: the retired multi-collective layout — separate
          capacity-padded data/valid/bucket/src((+pos)) tensors per hop.
        wan_wire_bytes: with transfers quantized to ``wire_segment_records``
          (the §3.5.1 S_min clamp), each tile's payload rounds up to whole
          wire segments.
        """
        if self.num_devices != dcs * nodes:
            raise ValueError(f"plan covers {self.num_devices} ranks, "
                             f"topology has {dcs * nodes}")
        if wire_meta not in WIRE_META_MODES:
            raise ValueError(f"wire_meta={wire_meta!r} not in "
                             f"{WIRE_META_MODES}")
        if self.hierarchical:
            tiles, cap = dcs - 1, self.capacities[1]
            meta = _WIRE_META_HIER[wire_meta]
            legacy_tensors = rec_bytes + 1 + 4 + 4 + 4  # +valid,bucket,src,pos
        else:
            tiles, cap = (dcs - 1) * nodes, self.capacities[0]
            meta = _WIRE_META_FLAT[wire_meta]
            legacy_tensors = rec_bytes + 1 + 4 + 4      # +valid,bucket,src
        frame = WireFrame("uint8", (rec_bytes,), meta=meta)
        w = self.chunks
        cap_c = -(-cap // w)
        frame_rows = cap_c + 1                          # + count header row
        out = {
            "wan_tiles": tiles,
            "wan_rounds": w,
            "wan_slot_bytes": tiles * cap * rec_bytes,
            "wan_frame_bytes": tiles * w * frame.tile_nbytes(cap_c),
            "wan_legacy_bytes": tiles * cap * legacy_tensors,
        }
        if wire_segment_records:
            q = wire_segment_records
            out["wan_wire_bytes"] = tiles * (-(-cap // q) * q) * rec_bytes
            out["wan_frame_wire_bytes"] = (
                tiles * w * (-(-frame_rows // q) * q) * frame.row_nbytes)
        return out
