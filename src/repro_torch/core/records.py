"""RecordCodec and WireFrame: fixed-shape records <-> flat byte rows.

Port of ``repro/core/records.py``. A **record** is any fixed-shape tree
(dict / tuple / list) of arrays sharing leading record axes; the codec
packs each record into one fixed-width byte row, with the same layout in
two worlds:

- ``pack`` / ``unpack``: torch ops (``Tensor.view(torch.uint8)``), used by
  :class:`repro_torch.sphere.dataflow.SPMDExecutor` to ship records
  through the capacity-bounded shuffle;
- ``encode`` / ``decode``: the numpy mirror, byte-identical to ``pack``
  and to the JAX package's ``encode`` — a bucket file written by either
  package is readable by the other.

Dict trees flatten in sorted-key order, as JAX's pytrees do; the byte
layout depends on it, so the port carries its own small flatten instead
of a private torch API. Layout is little-endian; bools travel as one byte.

Torch tensors may carry any number of leading axes (``(n, ...)`` for one
rank, ``(ranks, n, ...)`` stacked); the codec's ``shapes`` are the
per-record trailing shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# -- trees ---------------------------------------------------------------------

#: treedef of a single array leaf
LEAF = "*"


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """Leaves in JAX pytree order (dict keys sorted) and a hashable
    treedef."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        leaves: List[Any] = []
        defs = []
        for k in keys:
            sub, d = tree_flatten(tree[k])
            leaves += sub
            defs.append(d)
        return leaves, ("dict", keys, tuple(defs))
    if isinstance(tree, (tuple, list)):
        leaves, defs = [], []
        for x in tree:
            sub, d = tree_flatten(x)
            leaves += sub
            defs.append(d)
        return leaves, (type(tree).__name__, tuple(defs))
    return [tree], LEAF


def tree_unflatten(treedef: Any, leaves: Sequence[Any]) -> Any:
    return _build(treedef, iter(leaves))


def _build(d: Any, it) -> Any:
    # module-level, not a recursive closure: a closure that calls itself is
    # a reference cycle, which would keep ``leaves`` (whole record buffers)
    # alive until the cyclic garbage collector happens to run
    if d == LEAF:
        return next(it)
    if d[0] == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    items = [_build(c, it) for c in d[1]]
    return tuple(items) if d[0] == "tuple" else items


def tree_map(fn, tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


# -- dtypes --------------------------------------------------------------------

_TORCH_DTYPES: Dict[str, torch.dtype] = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "uint16": torch.uint16, "int32": torch.int32,
    "uint32": torch.uint32, "int64": torch.int64, "uint64": torch.uint64,
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64,
    # numpy has no bfloat16: the name stands on its own (MoE records)
    "bfloat16": torch.bfloat16,
}
_NUMPY_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(name: str) -> torch.dtype:
    if name in _TORCH_DTYPES:
        return _TORCH_DTYPES[name]
    try:
        return _TORCH_DTYPES[str(np.dtype(name))]
    except KeyError:
        raise TypeError(f"no torch dtype for {name!r}") from None


def dtype_name(dtype: Any) -> str:
    """numpy name of a torch or numpy dtype (the codecs' schema strings)."""
    if isinstance(dtype, torch.dtype):
        try:
            return _NUMPY_NAMES[dtype]
        except KeyError:
            raise TypeError(f"unsupported record dtype {dtype}") from None
    return str(np.dtype(dtype))


def _to_bytes(x: torch.Tensor, lead: Tuple[int, ...], nbytes: int
              ) -> torch.Tensor:
    if x.numel() == 0:
        return torch.zeros(lead + (nbytes,), dtype=torch.uint8,
                           device=x.device)
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.contiguous().view(torch.uint8).reshape(lead + (nbytes,))


def _from_bytes(piece: torch.Tensor, lead: Tuple[int, ...],
                dtype: str, shape: Tuple[int, ...]) -> torch.Tensor:
    tdt = torch_dtype(dtype)
    if tdt == torch.bool:
        return piece.reshape(lead + shape) != 0
    if tdt.itemsize == 1:
        return piece.view(tdt).reshape(lead + shape)
    if piece.numel() == 0:
        return torch.zeros(lead + shape, dtype=tdt, device=piece.device)
    if not piece.is_contiguous() or piece.storage_offset() % tdt.itemsize:
        piece = piece.clone(memory_format=torch.contiguous_format)
    return piece.view(tdt).reshape(lead + shape)


@dataclasses.dataclass(frozen=True)
class RecordCodec:
    """Schema of one record: a tree structure plus per-leaf dtype/shape.

    ``dtypes`` are numpy dtype names, ``shapes`` the per-record trailing
    shapes. ``layout[i]`` is the flattened leaf stored at byte-position i
    of a packed row (lets the on-disk field order differ from the sorted
    dict flatten order).
    """

    treedef: Any
    dtypes: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    layout: Tuple[int, ...] = ()

    def __post_init__(self):
        if len(self.dtypes) != len(self.shapes):
            raise ValueError("one dtype per field required")
        if not self.layout:
            object.__setattr__(self, "layout",
                               tuple(range(len(self.dtypes))))
        if sorted(self.layout) != list(range(len(self.dtypes))):
            raise ValueError(f"layout {self.layout} is not a permutation of "
                             f"the {len(self.dtypes)} fields")

    # -- geometry -------------------------------------------------------------
    @property
    def field_nbytes(self) -> Tuple[int, ...]:
        return tuple(
            int(np.dtype(dt).itemsize * np.prod(s, dtype=np.int64))
            for dt, s in zip(self.dtypes, self.shapes))

    @property
    def nbytes(self) -> int:
        """Packed bytes per record."""
        return sum(self.field_nbytes)

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_example(cls, records: Any, batch_dims: int = 1) -> "RecordCodec":
        """Infer the schema from a records tree whose leaves (tensors or
        numpy arrays) share ``batch_dims`` leading record axes."""
        leaves, treedef = tree_flatten(records)
        if not leaves:
            raise ValueError("records tree has no array leaves")
        lead = tuple(leaves[0].shape[:batch_dims])
        for leaf in leaves:
            if (len(leaf.shape) < batch_dims
                    or tuple(leaf.shape[:batch_dims]) != lead):
                raise ValueError("all record fields need the same leading "
                                 f"record axes; got shapes "
                                 f"{[tuple(x.shape) for x in leaves]}")
        return cls(treedef=treedef,
                   dtypes=tuple(dtype_name(l.dtype) for l in leaves),
                   shapes=tuple(tuple(l.shape[batch_dims:]) for l in leaves))

    @classmethod
    def from_fields(cls, fields: dict) -> "RecordCodec":
        """Build from ``{name: dtype}`` or ``{name: (dtype, trailing_shape)}``
        — records are then dicts. The **insertion order** of ``fields`` is
        the byte layout, though dicts flatten in sorted-key order."""
        spec = {}
        for name, f in fields.items():
            dt, shape = f if isinstance(f, tuple) else (f, ())
            spec[name] = (dtype_name(dt), tuple(shape))
        _, treedef = tree_flatten({k: 0 for k in spec})
        names = sorted(spec)
        return cls(treedef=treedef,
                   dtypes=tuple(spec[k][0] for k in names),
                   shapes=tuple(spec[k][1] for k in names),
                   layout=tuple(names.index(k) for k in fields))

    # -- torch path -----------------------------------------------------------
    def _lead(self, leaves: Sequence[Any]) -> Tuple[int, ...]:
        x = leaves[0]
        return tuple(x.shape[:len(x.shape) - len(self.shapes[0])])

    def pack(self, records: Any) -> torch.Tensor:
        """(tree with leading axes ``lead``) -> ``lead + (nbytes,)`` uint8."""
        leaves = self._check(records)
        lead = self._lead(leaves)
        nbytes = self.field_nbytes
        cols = [_to_bytes(torch.as_tensor(leaves[i]), lead, nbytes[i])
                for i in self.layout]
        return cols[0].clone() if len(cols) == 1 else torch.cat(cols, dim=-1)

    def unpack(self, packed: torch.Tensor) -> Any:
        """``(..., nbytes)`` uint8 -> tree with leading axes ``...``.
        Byte fields come back as views of ``packed``."""
        if packed.shape[-1] != self.nbytes:
            raise ValueError(f"packed rows are {packed.shape[-1]} bytes, "
                             f"codec expects {self.nbytes}")
        lead = tuple(packed.shape[:-1])
        nbytes = self.field_nbytes
        leaves: List[Optional[torch.Tensor]] = [None] * len(self.dtypes)
        off = 0
        for i in self.layout:
            piece = packed[..., off:off + nbytes[i]]
            leaves[i] = _from_bytes(piece, lead, self.dtypes[i],
                                    self.shapes[i])
            off += nbytes[i]
        return tree_unflatten(self.treedef, leaves)

    # -- numpy path (Sector files) --------------------------------------------
    def encode(self, records: Any) -> np.ndarray:
        """(tree with leading axis n) -> (n, nbytes) uint8 ndarray,
        byte-identical to :meth:`pack` of the same records."""
        leaves = self._check(records)
        n = int(leaves[0].shape[0])
        nbytes = self.field_nbytes
        cols = []
        for i in self.layout:
            x = np.asarray(leaves[i])
            if x.dtype == np.bool_:
                x = x.astype(np.uint8)
            raw = np.ascontiguousarray(x).tobytes()
            cols.append(np.frombuffer(raw, np.uint8).reshape(n, nbytes[i]))
        if not cols:
            return np.zeros((n, 0), np.uint8)
        return np.concatenate(cols, axis=1)

    def decode(self, buf: Any) -> Any:
        """bytes or (n, nbytes)/(n*nbytes,) uint8 -> tree of np arrays."""
        if isinstance(buf, (bytes, bytearray, memoryview)):
            buf = np.frombuffer(buf, np.uint8)
        buf = np.asarray(buf, np.uint8).reshape(-1, self.nbytes)
        n = buf.shape[0]
        nbytes = self.field_nbytes
        leaves: List[Any] = [None] * len(self.dtypes)
        off = 0
        for i in self.layout:
            dtype, shape, nb = np.dtype(self.dtypes[i]), self.shapes[i], nbytes[i]
            piece = np.ascontiguousarray(buf[:, off:off + nb])
            if dtype == np.bool_:
                leaf = piece.reshape((n,) + shape).astype(np.bool_)
            else:
                leaf = np.frombuffer(piece.tobytes(), dtype=dtype)
                leaf = leaf.reshape((n,) + shape)
            leaves[i] = leaf
            off += nb
        return tree_unflatten(self.treedef, leaves)

    # -- internals ------------------------------------------------------------
    def _check(self, records: Any) -> Sequence[Any]:
        leaves, treedef = tree_flatten(records)
        if treedef != self.treedef:
            raise ValueError(f"records structure {treedef} does not match "
                             f"codec structure {self.treedef}")
        for leaf, dt, shape in zip(leaves, self.dtypes, self.shapes):
            tail = tuple(leaf.shape[len(leaf.shape) - len(shape):]) \
                if shape else ()
            if (dtype_name(leaf.dtype) != dt or tail != shape
                    or len(leaf.shape) <= len(shape)):
                raise ValueError(
                    f"field mismatch: got {dtype_name(leaf.dtype)}"
                    f"{tuple(leaf.shape)}, codec expects {dt} with trailing "
                    f"shape {shape}")
        return leaves


# -- wire framing -------------------------------------------------------------


#: bytes of the per-tile count header (one int32 per destination tile).
COUNT_NBYTES = 4


@dataclasses.dataclass(frozen=True)
class WireFrame:
    """Header codec for the one-wire-tensor shuffle hop.

    Each record becomes one byte row holding its payload plus the
    per-record metadata the hop needs; validity travels either
    **positionally** (the default: real records fill each destination
    tile's prefix, so one int32 count per tile, in a header row that
    :meth:`seal` prepends, encodes the slot mask) or **explicitly**
    (``explicit_valid=True``: a leading validity byte per row).

    Row layout (little-endian, as :class:`RecordCodec`):
    ``[valid u8?][meta int32 x len(meta)][payload bytes][zero pad]``.
    Rows are at least ``COUNT_NBYTES`` wide in positional mode.
    """

    payload_dtype: str
    payload_shape: Tuple[int, ...]   # trailing shape of one record
    meta: Tuple[str, ...] = ()
    explicit_valid: bool = False

    # -- geometry -------------------------------------------------------------
    @property
    def payload_nbytes(self) -> int:
        return int(torch_dtype(self.payload_dtype).itemsize
                   * np.prod(self.payload_shape, dtype=np.int64))

    @property
    def meta_nbytes(self) -> int:
        return 4 * len(self.meta)

    @property
    def row_nbytes(self) -> int:
        base = ((1 if self.explicit_valid else 0)
                + self.meta_nbytes + self.payload_nbytes)
        return base if self.explicit_valid else max(base, COUNT_NBYTES)

    def tile_nbytes(self, capacity: int) -> int:
        """Wire bytes of one destination tile at ``capacity`` slots (incl.
        the count header row in positional mode)."""
        rows = capacity if self.explicit_valid else capacity + 1
        return rows * self.row_nbytes

    # -- constructors ---------------------------------------------------------
    @classmethod
    def for_payload(cls, payload: Any, meta: Sequence[str] = (),
                    explicit_valid: bool = False,
                    batch_dims: int = 1) -> "WireFrame":
        """Infer the payload schema from an array whose first
        ``batch_dims`` axes are record axes."""
        return cls(payload_dtype=dtype_name(payload.dtype),
                   payload_shape=tuple(payload.shape[batch_dims:]),
                   meta=tuple(meta), explicit_valid=explicit_valid)

    # -- framing --------------------------------------------------------------
    def frame_rows(self, payload: torch.Tensor,
                   valid: Optional[torch.Tensor] = None,
                   **meta: torch.Tensor) -> torch.Tensor:
        """``lead + payload_shape`` plus per-record metadata ->
        ``lead + (row_nbytes,)`` uint8. ``valid`` is required iff
        ``explicit_valid``; rows with ``valid == False`` are zeroed."""
        if set(meta) != set(self.meta):
            raise ValueError(f"frame meta {sorted(meta)} != schema "
                             f"{sorted(self.meta)}")
        if self.explicit_valid == (valid is None):
            raise ValueError("valid= required iff explicit_valid")
        lead = tuple(payload.shape[:payload.dim() - len(self.payload_shape)])
        cols = []
        if self.explicit_valid:
            cols.append(valid.to(torch.uint8).reshape(lead + (1,)))
        for name in self.meta:
            m = torch.as_tensor(meta[name]).to(torch.int32).reshape(lead)
            cols.append(_to_bytes(m, lead, 4))
        cols.append(_to_bytes(payload, lead, self.payload_nbytes))
        used = sum(c.shape[-1] for c in cols)
        if used < self.row_nbytes:
            cols.append(torch.zeros(lead + (self.row_nbytes - used,),
                                    dtype=torch.uint8, device=payload.device))
        rows = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
        if self.explicit_valid:
            rows = rows * valid.to(torch.uint8).reshape(lead + (1,))
        return rows

    def open_rows(self, rows: torch.Tensor):
        """``(..., row_nbytes)`` uint8 -> (payload, valid_or_None, {meta}).
        ``valid`` is decoded only in explicit mode."""
        if rows.shape[-1] != self.row_nbytes:
            raise ValueError(f"rows are {rows.shape[-1]} bytes, frame "
                             f"expects {self.row_nbytes}")
        lead = tuple(rows.shape[:-1])
        off = 0
        valid = None
        if self.explicit_valid:
            valid = rows[..., 0] != 0
            off = 1
        metas = {}
        for name in self.meta:
            metas[name] = _from_bytes(rows[..., off:off + 4], lead,
                                      "int32", ())
            off += 4
        payload = _from_bytes(rows[..., off:off + self.payload_nbytes], lead,
                              self.payload_dtype, self.payload_shape)
        return payload, valid, metas

    # -- tile sealing (positional-validity mode) ------------------------------
    def seal(self, tiles: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        """Prepend the count header row: ``(..., D, C, row)`` + ``(..., D)``
        int32 counts (already clamped to C) -> ``(..., D, C+1, row)``."""
        if self.explicit_valid:
            raise ValueError("seal() is for positional-validity frames")
        lead = tuple(tiles.shape[:-2])
        hdr = torch.zeros(lead + (1, self.row_nbytes), dtype=torch.uint8,
                          device=tiles.device)
        hdr[..., 0, :COUNT_NBYTES] = _to_bytes(counts.to(torch.int32), lead,
                                               COUNT_NBYTES)
        return torch.cat([hdr, tiles], dim=-2)

    def open(self, wire: torch.Tensor):
        """Inverse of :meth:`seal` after the exchange: ``(..., D, C+1,
        row)`` -> (payload ``(..., D, C, *shape)``, valid ``(..., D, C)``
        bool, {meta ``(..., D, C)`` int32})."""
        if self.explicit_valid:
            raise ValueError("open() is for positional-validity frames")
        hdr = wire[..., 0, :COUNT_NBYTES]
        counts = _from_bytes(hdr, tuple(hdr.shape[:-1]), "int32", ())
        rows = wire[..., 1:, :]
        cap = rows.shape[-2]
        counts = counts.clamp(0, cap)
        valid = (torch.arange(cap, dtype=torch.int32, device=wire.device)
                 < counts[..., None])
        payload, _, metas = self.open_rows(rows)
        return payload, valid, metas
