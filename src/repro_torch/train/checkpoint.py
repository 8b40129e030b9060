"""Sector-backed checkpointing (fault tolerance for training).

Port of ``repro/train/checkpoint.py``. Checkpoints are stored *in Sector*
as whole-file slices (paper §2.2): the serialized state is chunked into
``num_slices`` Sector files plus a JSON manifest carrying per-slice MD5
checksums. Durability comes from Sector's replication daemon; restore
verifies every checksum.

The bytes are the JAX package's: leaves in its tree order (dict keys
sorted, lists in order; :func:`repro_torch.train.trainer.state_tree`
lays the port's state out so), each leaf's raw little-endian bytes at
the manifest's offsets, the same slice split. So both packages write the
same slices (the same MD5s) for the same state, and either restores the
other's checkpoint; the manifest's ``treedef`` string is each package's
own and neither restore reads it. A
:class:`repro_torch.models.convert.Stacked` leaf is written layer after
layer, the bytes of the stacked array, without stacking it on the
device. bfloat16 leaves are their raw 2-byte words under ``dtype:
"bfloat16"`` (numpy has no bfloat16 without ``ml_dtypes``; torch reads
them back directly).

``save`` copies the whole state to one host buffer before it returns
(the train step then updates the parameters in place); with
``blocking=False`` only the upload runs on a background thread,
overlapping the next steps. The slices upload side by side, one thread
each (each slave hashes what it writes), each brought to the replication
factor by its thread as soon as it is written (the daemon's later pass
finds them whole), and ``restore`` reads and checks them side by side
the same way; ``device=`` puts the restored tree on a device.

**Over process ranks** (``ranks=`` a :class:`repro_torch.comm.ProcessRanks`
grid, ``specs=`` the state's specs in the tree's layout,
:func:`repro_torch.train.trainer.state_specs`) each process hands in its
own blocks and the checkpoint is the same manifest and the same slice
bytes the one-process ``save`` writes for the whole state, so any
package on any grid restores it. No process holds the whole state:

- slice ``i`` has one owner, process ``i * world // num_slices``; a
  *piece* (a leaf, or one layer of a stacked leaf) belongs to the owner
  of the slice that holds its first byte;
- save: one ``all_to_all_v`` sends each distinct block (from the first
  process that holds it) to its piece's owner, which puts the piece
  together; one more sends the bytes of each piece to the owners of the
  slices they fall in; each owner uploads its slices (computing their
  MD5s) and brings them to the replication factor; process 0 gathers
  each slice's ``(path, md5, nbytes)`` and holders, writes the manifest,
  and every process's master view learns the files (what a scan of the
  slaves would give, without reading them);
- restore onto any grid (``specs`` the new grid's): each slice owner
  downloads its slices and checks their MD5s (a bad one raises on every
  process); the pieces are dealt, largest first, to the process with the
  fewest block bytes to send yet (a block held by several processes is
  sent to each: one owner of the replicated parameters would send them
  all); one ``all_to_all_v`` brings every piece's bytes to its owner, one
  more sends each process its blocks under the new specs
  (:func:`repro_torch.comm.shard_slices`), on ``ranks.device``.

The exchanges move at most ``EXCHANGE_BYTES`` a process a round, as host
bytes: beside NCCL, which carries CUDA tensors only, they and the
gathers take the grid's gloo group (``ProcessRanks.host_group``). With
``blocking=False`` only the upload runs on the background thread: the
exchanges, and the gather that ends a save (run by the next ``save``,
``wait`` or ``restore``), are collectives on the calling thread, so
every process calls them in the same order.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import math
import os
import threading
import time
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.comm import Spec, grid_coords, shard_slices, spec_axes
from repro_torch.models.convert import Stacked
from repro_torch.sector.client import SectorClient
from repro_torch.sector.master import FileMeta

#: the manifest's dtype names (numpy's) and torch's dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
          "int8": torch.int8, "bool": torch.bool}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}
#: the bytes a process hands an exchange in one round, over all its peers
EXCHANGE_BYTES = 1 << 30


def _leaves(tree) -> Iterator[Any]:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, lists and
    tuples in order, ``None`` no leaf, a :class:`Stacked` one leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Stacked):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _parts(leaf) -> List[torch.Tensor]:
    parts = list(leaf) if isinstance(leaf, Stacked) else [leaf]
    return [p if isinstance(p, torch.Tensor)
            else torch.as_tensor(np.ascontiguousarray(p)) for p in parts]


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Stacked):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "None" if tree is None else "*"


def _table(leaves: Sequence[Tuple[Sequence[int], torch.dtype]]) -> List[Dict]:
    meta, off = [], 0
    for shape, dtype in leaves:
        nbytes = math.prod(shape) * dtype.itemsize
        meta.append({"shape": [int(n) for n in shape],
                     "dtype": DTYPE_NAMES[dtype], "offset": off,
                     "nbytes": nbytes})
        off += nbytes
    return meta


def leaf_table(tree) -> List[Dict]:
    """The manifest's leaf table of ``tree`` (each leaf's shape, dtype,
    offset and bytes) from its tensors' shapes and dtypes alone: tensors
    on the ``meta`` device do."""
    out = []
    for leaf in _leaves(tree):
        parts = _parts(leaf)
        out.append((([len(parts)] if isinstance(leaf, Stacked) else [])
                    + list(parts[0].shape), parts[0].dtype))
    return _table(out)


def _serialize_tree(tree) -> Tuple[np.ndarray, Dict]:
    """The leaves' bytes in one host buffer (uint8), and the manifest's
    leaf table. Each tensor is copied straight into its range."""
    meta = leaf_table(tree)
    buf = torch.empty(sum(m["nbytes"] for m in meta), dtype=torch.uint8)
    for leaf, m in zip(_leaves(tree), meta):
        o = m["offset"]
        for p in _parts(leaf):
            n = p.numel() * p.element_size()
            buf[o:o + n].copy_(p.detach().contiguous().reshape(-1)
                               .view(torch.uint8))
            o += n
    return buf.numpy(), {"leaves": meta, "treedef": _structure(tree)}


def _deserialize_leaves(blob: np.ndarray, meta: Dict,
                        device=None) -> List[torch.Tensor]:
    data = torch.from_numpy(blob)
    out = []
    for m in meta["leaves"]:
        raw = data[m["offset"]:m["offset"] + m["nbytes"]]
        dtype = DTYPES[m["dtype"]]
        if device is not None:
            raw = raw.to(device)
        if raw.storage_offset() % dtype.itemsize:
            raw = raw.clone()                 # view() needs aligned words
        out.append(raw.view(dtype).reshape(m["shape"]))
    return out


def _rebuild(like, leaves: Iterator[Any]):
    """``like``'s structure with the next leaves put in its places (a
    stacked leaf as a :class:`Stacked`: one given so, or the views of a
    loaded array's layers)."""
    if isinstance(like, dict):
        out = {k: None for k in like}
        for k in sorted(like):
            out[k] = _rebuild(like[k], leaves)
        return out
    if isinstance(like, (list, tuple)) and not isinstance(like, Stacked):
        return type(like)(_rebuild(v, leaves) for v in like)
    if like is None:
        return None
    leaf = next(leaves)
    if isinstance(like, Stacked) and not isinstance(leaf, Stacked):
        return Stacked(leaf.unbind(0))
    return leaf


def _md5(buf) -> str:
    return hashlib.md5(buf).hexdigest()


# -- over process ranks: the plan every process computes alike ----------------


class _Piece(NamedTuple):
    """A leaf, or one layer of a stacked leaf: its place in the
    checkpoint's bytes, its global shape and dtype, and its spec."""
    offset: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Spec

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def _paired(tree, specs) -> Iterator[Tuple[Any, Any]]:
    """``(leaf, spec)`` of ``tree`` and the same tree of specs, in
    :func:`_leaves`' order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paired(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Stacked):
        if len(tree) != len(specs):
            raise ValueError(f"{len(tree)} leaves against {len(specs)} specs")
        for v, s in zip(tree, specs):
            yield from _paired(v, s)
    elif tree is not None:
        yield tree, specs


def _layer_specs(spec, layers: int) -> List[Spec]:
    """A stacked leaf's per-layer specs: a :class:`Stacked` (or list) of
    them, or one spec led by ``None`` for the layer axis."""
    if isinstance(spec, (Stacked, list)):
        if len(spec) != layers:
            raise ValueError(f"{len(spec)} specs for {layers} layers")
        return [tuple(s) for s in spec]
    if not spec or spec[0] is not None:
        raise ValueError(f"a stacked leaf's spec {spec} does not lead with "
                         f"None for its layer axis")
    return [tuple(spec[1:])] * layers


def _global_shape(local: Sequence[int], spec: Spec, ranks) -> Tuple[int, ...]:
    sizes = dict(zip(ranks.axes, ranks.shape))
    out = list(local)
    for d, e in enumerate(spec):
        if e is not None:
            out[d] *= math.prod(sizes[a] for a in
                                ((e,) if isinstance(e, str) else e))
    return tuple(out)


def _first_holder(spec: Spec, ranks, r: int) -> bool:
    """Whether flat rank ``r`` is the first of those holding its block
    under ``spec`` (index 0 on every axis the spec does not name)."""
    named = spec_axes(spec)
    return all(c == 0 for a, c in zip(ranks.axes,
                                      grid_coords(ranks.shape, r))
               if a not in named)


def _block(piece: _Piece, ranks, r: int) -> Tuple[slice, ...]:
    return shard_slices(piece.shape, piece.spec, ranks.shape, ranks.axes, r)


def _block_shape(shape, blocks) -> Tuple[int, ...]:
    return tuple(len(range(n)[sl]) for n, sl in zip(shape, blocks))


def _owner(i: int, num_slices: int, world: int) -> int:
    return i * world // num_slices


def _balanced_owners(pieces: Sequence[_Piece], ranks) -> List[int]:
    """A restore's piece owners: each piece, largest first, to the
    process with the fewest bytes to send yet, counting every process's
    block of it (a block held by several processes is sent to each), so
    that no owner sends the replicated parameters alone."""
    load = [0] * ranks.world
    owner = [0] * len(pieces)
    sizes = [sum(math.prod(_block_shape(p.shape, _block(p, ranks, r)))
                 for r in range(ranks.world)) * p.dtype.itemsize
             for p in pieces]
    for k in sorted(range(len(pieces)), key=lambda k: (-sizes[k], k)):
        owner[k] = min(range(ranks.world), key=lambda r: (load[r], r))
        load[owner[k]] += sizes[k]
    return owner


class _Slices:
    """The slices' byte ranges and owners."""

    def __init__(self, sizes: Sequence[int], world: int):
        self.starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.owners = [_owner(i, len(sizes), world)
                       for i in range(len(sizes))]

    def of(self, offset: int) -> int:
        """The slice holding byte ``offset`` (the last for the end)."""
        i = int(np.searchsorted(self.starts, offset, side="right")) - 1
        return min(max(i, 0), len(self.owners) - 1)

    def overlaps(self, lo: int, hi: int) -> Iterator[Tuple[int, int, int]]:
        """``(slice, lo, hi)`` of each slice the bytes ``[lo, hi)`` fall
        in."""
        i = self.of(lo)
        while lo < hi:
            end = min(hi, int(self.starts[i + 1]))
            if end > lo:
                yield i, lo, end
            lo = end
            i += 1


def _agree(ranks, what: str, error: Optional[str],
           kind: type = ValueError) -> None:
    """Raise ``kind`` on every process if any process has an ``error``:
    a fault found by one process never leaves the others waiting in a
    collective."""
    errors = ranks.all_gather_object(error)
    bad = [(r, e) for r, e in enumerate(errors) if e]
    if bad:
        raise kind(f"{what}: " + "; ".join(f"process {r}: {e}"
                                           for r, e in bad))


def _exchange(ranks, items: Sequence[Tuple[int, int, int, Any]],
              payload: Callable[[Any], torch.Tensor],
              place: Callable[[Any, int, torch.Tensor], None]) -> int:
    """Move every item ``(src, dst, nbytes, key)`` (one list, in one order,
    on every process) from ``src`` to ``dst`` through ``all_to_all_v``
    over the whole grid, in rounds of at most ``EXCHANGE_BYTES // world``
    bytes a pair; an item a process sends itself is placed directly.
    ``payload(key)`` gives the item's bytes on ``src`` (a uint8 tensor,
    made when the item is first sent); ``place(key, at, chunk)`` takes
    them on ``dst``, ``chunk`` the bytes from ``at`` on. Returns the bytes
    this process handed to the transport."""
    world, me = ranks.world, ranks.rank
    cap = max(1, EXCHANGE_BYTES // world)
    pair = np.zeros((world, world), np.int64)
    for src, dst, n, key in items:
        if src != dst:
            pair[src, dst] += n
        elif src == me and n:                # this process's own bytes
            place(key, 0, payload(key).reshape(-1))
    rounds = int(-(-pair.max() // cap)) if pair.size else 0
    outbox = [[(n, key) for src, dst, n, key in items if src == me
               and dst == d != me and n] for d in range(world)]
    inbox = [[(n, key) for src, dst, n, key in items if dst == me
              and src == s != me and n] for s in range(world)]
    out_at = [[0, 0, None] for _ in range(world)]     # item, byte, bytes
    in_at = [[0, 0] for _ in range(world)]

    def take(d: int, n: int) -> List[torch.Tensor]:
        parts, cur = [], out_at[d]
        while n:
            size, key = outbox[d][cur[0]]
            if cur[2] is None:
                cur[2] = payload(key).reshape(-1)
            k = min(n, size - cur[1])
            parts.append(cur[2][cur[1]:cur[1] + k])
            n -= k
            cur[1] += k
            if cur[1] == size:
                cur[:] = [cur[0] + 1, 0, None]
        return parts

    sent = 0
    for r in range(rounds):
        send = [int(min(cap, max(0, pair[me, d] - r * cap)))
                for d in range(world)]
        recv = [int(min(cap, max(0, pair[s, me] - r * cap)))
                for s in range(world)]
        parts = [p for d in range(world) for p in take(d, send[d])]
        buf = (torch.cat(parts) if parts
               else torch.empty(0, dtype=torch.uint8))
        got = ranks.all_to_all_v(buf.unsqueeze(0), send, recv, None)[0]
        sent += buf.numel()
        off = 0
        for s in range(world):
            n, cur = recv[s], in_at[s]
            while n:
                size, key = inbox[s][cur[0]]
                k = min(n, size - cur[1])
                place(key, cur[1], got[off:off + k])
                off += k
                n -= k
                cur[1] += k
                if cur[1] == size:
                    cur[:] = [cur[0] + 1, 0]
    return sent


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)


class _Staged:
    """Items put together from their chunks: a uint8 buffer each, handed
    to ``done(key, buffer)`` when its last byte arrives."""

    def __init__(self, sizes: Dict[Any, int],
                 done: Callable[[Any, torch.Tensor], None]):
        self.sizes, self.done = sizes, done
        self.bufs: Dict[Any, torch.Tensor] = {}
        self.filled: Dict[Any, int] = {}

    def __call__(self, key, at: int, chunk: torch.Tensor) -> None:
        buf = self.bufs.get(key)
        if buf is None:
            buf = self.bufs[key] = torch.empty(self.sizes[key],
                                               dtype=torch.uint8)
            self.filled[key] = 0
        buf[at:at + chunk.numel()] = chunk
        self.filled[key] += chunk.numel()
        if self.filled[key] == self.sizes[key]:
            del self.bufs[key], self.filled[key]
            self.done(key, buf)


def _save_layout(tree, specs, ranks) -> Tuple[Dict, List[_Piece], List]:
    """A process save's manifest table (from the global shapes its blocks
    and their specs give), its pieces and this process's block of each."""
    leaves, pieces, blocks = [], [], []
    off = 0
    for leaf, spec in _paired(tree, specs):
        parts = _parts(leaf)
        layer_specs = (_layer_specs(spec, len(parts))
                       if isinstance(leaf, Stacked) else [tuple(spec)])
        shapes = {_global_shape(p.shape, sp, ranks)
                  for p, sp in zip(parts, layer_specs)}
        if len(shapes) != 1:
            raise ValueError(f"the layers of a stacked leaf have global "
                             f"shapes {sorted(shapes)}")
        shape = shapes.pop()
        lead = [len(parts)] if isinstance(leaf, Stacked) else []
        leaves.append((lead + list(shape), parts[0].dtype))
        for p, sp in zip(parts, layer_specs):
            pieces.append(_Piece(off, shape, p.dtype, sp))
            blocks.append(p)
            off += pieces[-1].nbytes
    return ({"leaves": _table(leaves), "treedef": _structure(tree)},
            pieces, blocks)


class SectorCheckpointer:
    def __init__(self, client: SectorClient, prefix: str = "/ckpt",
                 num_slices: int = 8, keep: int = 3):
        self.client = client
        self.prefix = prefix.rstrip("/")
        self.num_slices = num_slices
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        #: a process save's upload, finished by :meth:`wait`
        self._pending: Optional[Dict] = None
        #: seconds and bytes of the last process save and restore
        self.timings: Dict[str, float] = {}

    # -- save ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return f"{self.prefix}/step_{step:08d}"

    def save(self, step: int, tree, blocking: bool = True, *,
             ranks=None, specs=None) -> None:
        """Write ``tree`` as checkpoint ``step``. Over process ``ranks``
        (see the module docstring) ``tree`` is this process's blocks and
        ``specs`` the same tree of their specs; every process of the grid
        calls it."""
        if ranks is not None and ranks.rows != ranks.world:
            self._save_ranks(step, tree, blocking, ranks, specs)
            return
        blob, meta = _serialize_tree(tree)
        if blocking:
            self._upload(step, blob, meta)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._upload, args=(step, blob, meta), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending is not None:
            self._finish()

    def _put(self, files: Sequence[Tuple[str, Any]],
             replicate: bool = False) -> List[FileMeta]:
        """Upload ``(path, bytes)`` pairs side by side, one thread a file
        (each slave computes its file's MD5, and hashlib releases the GIL
        over large buffers), each brought to the replication factor with
        ``replicate``; their metadata in order."""
        def put(path, data):
            fm = self.client.upload(path, data)
            if replicate:
                self.client.master.replicate(path)
            return fm
        with concurrent.futures.ThreadPoolExecutor(max(1, len(files))) as pool:
            return list(pool.map(lambda f: put(*f), files))

    def _upload(self, step: int, blob: np.ndarray, meta: Dict) -> None:
        d = self._step_dir(step)
        n = self.num_slices
        size = len(blob)
        per = (size + n - 1) // n if size else 1
        chunks = [memoryview(blob[i * per:(i + 1) * per]) for i in range(n)]
        slice_meta = [{"path": fm.path, "md5": fm.md5, "nbytes": len(chunk)}
                      for fm, chunk in zip(self._put(
                          [(f"{d}/slice.{i:05d}", chunk)
                           for i, chunk in enumerate(chunks)],
                          replicate=True), chunks)]
        manifest = dict(meta, step=step, total_bytes=size, slices=slice_meta)
        self._put([(f"{d}/MANIFEST.json", json.dumps(manifest).encode())],
                  replicate=True)
        self._gc()

    def _gc(self, ranks=None) -> None:
        """Delete all but the last ``keep`` checkpoints. Over process
        ranks process 0 deletes the files and the other views forget
        them."""
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            d = self._step_dir(s)
            for fm in self.client.ls(d + "/"):
                if ranks is not None and ranks.rank != 0:
                    self.client.master.forget(fm.path)
                    continue
                try:
                    self.client.delete(fm.path)
                except FileNotFoundError:
                    pass

    def _save_ranks(self, step: int, tree, blocking: bool, ranks,
                    specs) -> None:
        if specs is None:
            raise ValueError("a save over process ranks needs the blocks' "
                             "specs (trainer.state_specs)")
        self.wait()
        t0 = time.perf_counter()
        world, me = ranks.world, ranks.rank
        error, meta, pieces, blocks, off = None, {}, [], [], 0
        try:
            meta, pieces, blocks = _save_layout(tree, specs, ranks)
            off = sum(p.nbytes for p in pieces)
        except Exception as e:            # raised on every process below
            error = f"{type(e).__name__}: {e}"
        _agree(ranks, "the blocks do not fit their specs", error)
        # every process must plan the same checkpoint
        digest = _md5(json.dumps(meta).encode())
        digests = ranks.all_gather_object(digest)
        if len(set(digests)) != 1:
            raise ValueError(f"the processes' leaf tables differ: {digests}")
        total, n = off, self.num_slices
        per = (total + n - 1) // n if total else 1
        sizes = [max(0, min(total, (i + 1) * per) - min(total, i * per))
                 for i in range(n)]
        sl = _Slices(sizes, world)
        owner = [sl.owners[sl.of(p.offset)] for p in pieces]

        # 1: each distinct block to its piece's owner
        items, bshape = [], {}
        for k, p in enumerate(pieces):
            for r in range(world):
                if _first_holder(p.spec, ranks, r):
                    b = _block(p, ranks, r)
                    bshape[k, r] = b
                    items.append((r, owner[k], math.prod(
                        _block_shape(p.shape, b)) * p.dtype.itemsize,
                        (k, r)))
        full: Dict[int, torch.Tensor] = {}

        def put_block(key, buf):
            k, r = key
            p = pieces[k]
            if k not in full:
                full[k] = torch.empty(p.shape, dtype=p.dtype)
            b = bshape[key]
            full[k][b] = buf.view(p.dtype).reshape(_block_shape(p.shape, b))

        for k, p in enumerate(pieces):       # pieces with no bytes
            if owner[k] == me and not p.nbytes:
                full[k] = torch.empty(p.shape, dtype=p.dtype)
        t1 = time.perf_counter()
        sent = _exchange(ranks, items, lambda key: _as_bytes(blocks[key[0]]),
                         _Staged({it[3]: it[2] for it in items if it[1] == me},
                                 put_block))
        # 2: each piece's bytes to the owners of their slices
        mine = [i for i, o in enumerate(sl.owners) if o == me]
        bufs = {i: torch.empty(sizes[i], dtype=torch.uint8) for i in mine}
        items = [(owner[k], sl.owners[i], hi - lo, (k, i, lo, hi))
                 for k, p in enumerate(pieces)
                 for i, lo, hi in sl.overlaps(p.offset, p.offset + p.nbytes)]

        def piece_bytes(key):
            k, _, lo, hi = key
            b = full[k].reshape(-1).view(torch.uint8)
            return b[lo - pieces[k].offset:hi - pieces[k].offset]

        def put_bytes(key, at, chunk):
            _, i, lo, _ = key
            start = lo - int(sl.starts[i]) + at
            bufs[i][start:start + chunk.numel()] = chunk

        sent += _exchange(ranks, items, piece_bytes, put_bytes)
        del full
        t2 = time.perf_counter()
        self.timings = {"save_plan_s": t1 - t0, "save_exchange_s": t2 - t1,
                        "save_sent_bytes": sent}
        self._pending = {"step": step, "meta": meta, "total": total,
                         "ranks": ranks, "slices": [], "error": None,
                         "n": n}
        args = (self._step_dir(step), bufs, self._pending)
        if blocking:
            self._upload_slices(*args)
            self._finish()
        else:
            self._thread = threading.Thread(target=self._upload_slices,
                                            args=args, daemon=True)
            self._thread.start()

    def _upload_slices(self, d: str, bufs: Dict[int, torch.Tensor],
                       pending: Dict) -> None:
        """This process's slices uploaded (their MD5s computed here) and
        brought to the replication factor."""
        t0 = time.perf_counter()
        try:
            fms = self._put([(f"{d}/slice.{i:05d}", memoryview(buf.numpy()))
                             for i, buf in bufs.items()], replicate=True)
            pending["slices"] += [
                {"index": i, "path": fm.path, "md5": fm.md5,
                 "nbytes": fm.size, "holders": sorted(fm.locations)}
                for i, fm in zip(bufs, fms)]
        except Exception as e:             # raised on every process later
            pending["error"] = f"{type(e).__name__}: {e}"
        pending["upload_s"] = time.perf_counter() - t0

    def _finish(self) -> None:
        """The end of a process save, on every process: the slices' table
        gathered, the manifest written by process 0, every view told of
        the files, old checkpoints collected."""
        pending, self._pending = self._pending, None
        ranks = pending["ranks"]
        t0 = time.perf_counter()
        gathered = ranks.all_gather_object(
            {"slices": pending["slices"], "error": pending["error"],
             "upload_s": pending.get("upload_s", 0.0)})
        t1 = time.perf_counter()
        errors = [(r, g["error"]) for r, g in enumerate(gathered)
                  if g["error"]]
        if errors:
            raise IOError("a slice upload failed: " + "; ".join(
                f"process {r}: {e}" for r, e in errors))
        table = sorted((s for g in gathered for s in g["slices"]),
                       key=lambda s: s["index"])
        if [s["index"] for s in table] != list(range(pending["n"])):
            raise IOError(f"slices {[s['index'] for s in table]} of "
                          f"{pending['n']} uploaded")
        master = self.client.master
        for s in table:
            master.learn(FileMeta(s["path"], s["nbytes"], s["md5"],
                                  set(s["holders"])))
        d = self._step_dir(pending["step"])
        written = None
        if ranks.rank == 0:
            manifest = dict(pending["meta"], step=pending["step"],
                            total_bytes=pending["total"],
                            slices=[{"path": s["path"], "md5": s["md5"],
                                     "nbytes": s["nbytes"]} for s in table])
            try:
                fm = self.client.upload(f"{d}/MANIFEST.json",
                                        json.dumps(manifest).encode())
                master.replicate(fm.path)
                written = (fm.path, fm.size, fm.md5, sorted(fm.locations))
            except Exception as e:        # raised on every process below
                written = f"{type(e).__name__}: {e}"
        written = ranks.all_gather_object(written)[0]
        if isinstance(written, str):
            raise IOError(f"the manifest of step {pending['step']}: "
                          f"{written}")
        path, size, md5, holders = written
        master.learn(FileMeta(path, size, md5, set(holders)))
        self._gc(ranks)
        self.timings.update(
            save_upload_s=max(g["upload_s"] for g in gathered),
            save_gather_s=t1 - t0, save_finish_s=time.perf_counter() - t1)

    # -- restore ----------------------------------------------------------------
    def list_steps(self) -> List[int]:
        steps = set()
        for fm in self.client.ls(self.prefix + "/"):
            parts = fm.path[len(self.prefix) + 1:].split("/")
            if parts and parts[0].startswith("step_") and \
                    parts[-1] == "MANIFEST.json":
                steps.add(int(parts[0][5:]))
        return sorted(steps)

    def _manifest(self, step: Optional[int]) -> Tuple[Dict, int]:
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.prefix}")
        step = steps[-1] if step is None else step
        d = self._step_dir(step)
        return json.loads(self.client.download(f"{d}/MANIFEST.json")), step

    def restore(self, tree_like, step: Optional[int] = None, device=None, *,
                ranks=None, specs=None) -> Tuple[Any, int]:
        """Rebuild the tree (structure taken from ``tree_like``, a
        :class:`Stacked` leaf coming back as one of views of the loaded
        array) on ``device`` (default: the host); verify every slice MD5.
        Returns (tree, step).

        Over process ``ranks`` each process gets its blocks under
        ``specs`` (the grid's, in ``tree_like``'s layout) on
        ``ranks.device``: the JAX package's ``restore(...,
        shardings=)``, onto any grid (see the module docstring)."""
        self.wait()
        if ranks is not None and ranks.rows != ranks.world:
            return self._restore_ranks(tree_like, step, ranks, specs)
        manifest, step = self._manifest(step)
        blob = np.empty(manifest["total_bytes"], np.uint8)
        slices = manifest["slices"]
        starts = np.cumsum([0] + [sm["nbytes"] for sm in slices])

        def read(i: int) -> bool:
            chunk = self.client.download(slices[i]["path"])
            part = blob[starts[i]:starts[i + 1]]
            if len(chunk) != len(part):
                return False
            part[:] = np.frombuffer(chunk, np.uint8)
            del chunk
            return _md5(part) == slices[i]["md5"]

        # one thread a slice: reads and hashlib release the GIL over large
        # buffers
        with concurrent.futures.ThreadPoolExecutor(
                max(1, min(len(slices), os.cpu_count() or 1))) as pool:
            ok = list(pool.map(read, range(len(slices))))
        bad = [sm["path"] for sm, good in zip(slices, ok) if not good]
        if bad:
            raise IOError(f"checksum mismatch on {', '.join(bad)}")
        leaves = _deserialize_leaves(blob, manifest, device)
        return _rebuild(tree_like, iter(leaves)), step

    def _restore_ranks(self, tree_like, step: Optional[int], ranks,
                       specs) -> Tuple[Any, int]:
        if specs is None:
            raise ValueError("a restore over process ranks needs the grid's "
                             "specs (trainer.state_specs)")
        t0 = time.perf_counter()
        world, me = ranks.world, ranks.rank
        error, manifest = None, None
        try:
            manifest, step = self._manifest(step)
        except Exception as e:            # raised on every process below
            error = f"{type(e).__name__}: {e}"
        steps = ranks.all_gather_object(None if error else step)
        _agree(ranks, "no common checkpoint to restore",
               error or (None if len(set(steps)) == 1 else
                         f"step {step}, process 0's {steps[0]}"),
               FileNotFoundError)
        # the pieces, by the manifest's table and the grid's specs
        pieces, stacked, mine = [], [], {}
        try:
            pairs = list(_paired(tree_like, specs))
            if len(pairs) != len(manifest["leaves"]):
                raise ValueError(f"{len(pairs)} leaves to restore, "
                                 f"{len(manifest['leaves'])} in the "
                                 f"checkpoint")
            for (like, spec), m in zip(pairs, manifest["leaves"]):
                dtype, shape = DTYPES[m["dtype"]], tuple(m["shape"])
                layers = (_layer_specs(spec, shape[0])
                          if isinstance(like, Stacked) else [tuple(spec)])
                stacked.append(isinstance(like, Stacked))
                shape = shape[1:] if stacked[-1] else shape
                size = math.prod(shape) * dtype.itemsize
                for j, sp in enumerate(layers):
                    p = _Piece(m["offset"] + j * size, shape, dtype, sp)
                    pieces.append(p)
                    b = _block_shape(shape, _block(p, ranks, me))
                    parts = _parts(like) if like is not None else []
                    if j < len(parts) and parts[j].device.type != "meta" \
                            and tuple(parts[j].shape) != b:
                        raise ValueError(f"leaf at offset {m['offset']}: "
                                         f"{tuple(parts[j].shape)} is not "
                                         f"this process's block {b}")
        except Exception as e:            # raised on every process below
            error = f"{type(e).__name__}: {e}"
        _agree(ranks, "the checkpoint does not fit the tree", error)
        sl = _Slices([s["nbytes"] for s in manifest["slices"]], world)
        owner = _balanced_owners(pieces, ranks)

        # each owner reads its slices and checks their MD5s
        data: Dict[int, torch.Tensor] = {}
        error = None
        for i, sm in enumerate(manifest["slices"]):
            if sl.owners[i] != me:
                continue
            try:
                chunk = self.client.download(sm["path"])
                if _md5(chunk) != sm["md5"]:
                    error = f"checksum mismatch on {sm['path']}"
                    break
                data[i] = torch.empty(len(chunk), dtype=torch.uint8)
                data[i].numpy()[:] = np.frombuffer(chunk, np.uint8)
                del chunk
            except Exception as e:        # raised on every process below
                error = f"{sm['path']}: {type(e).__name__}: {e}"
                break
        t1 = time.perf_counter()
        _agree(ranks, "a slice failed", error, IOError)

        # A: each piece's bytes to its owner
        full: Dict[int, torch.Tensor] = {
            k: torch.empty(p.nbytes, dtype=torch.uint8)
            for k, p in enumerate(pieces) if owner[k] == me}
        items = [(sl.owners[i], owner[k], hi - lo, (k, i, lo, hi))
                 for k, p in enumerate(pieces)
                 for i, lo, hi in sl.overlaps(p.offset, p.offset + p.nbytes)]

        def slice_bytes(key):
            _, i, lo, hi = key
            start = int(sl.starts[i])
            return data[i][lo - start:hi - start]

        def put_piece(key, at, chunk):
            k, _, lo, _ = key
            start = lo - pieces[k].offset + at
            full[k][start:start + chunk.numel()] = chunk

        sent = _exchange(ranks, items, slice_bytes, put_piece)
        del data
        # B: each process's blocks under the grid's specs
        blocks = [None] * len(pieces)
        items = []
        for k, p in enumerate(pieces):
            for r in range(world):
                b = _block(p, ranks, r)
                items.append((owner[k], r, math.prod(
                    _block_shape(p.shape, b)) * p.dtype.itemsize, (k, r)))

        def block_bytes(key):
            k, r = key
            p = pieces[k]
            typed = full[k].view(p.dtype).reshape(p.shape)
            return _as_bytes(typed[_block(p, ranks, r)])

        def put_block(key, buf):
            k, _ = key
            p = pieces[k]
            shape = _block_shape(p.shape, _block(p, ranks, me))
            blocks[k] = buf.view(p.dtype).reshape(shape).to(ranks.device)

        for k, p in enumerate(pieces):
            if not p.nbytes or not math.prod(
                    _block_shape(p.shape, _block(p, ranks, me))):
                blocks[k] = torch.empty(
                    _block_shape(p.shape, _block(p, ranks, me)),
                    dtype=p.dtype, device=ranks.device)
        sent += _exchange(ranks, items, block_bytes,
                          _Staged({it[3]: it[2] for it in items
                                   if it[1] == me}, put_block))
        del full
        leaves, k = [], 0
        for is_stacked, m in zip(stacked, manifest["leaves"]):
            if is_stacked:
                leaves.append(Stacked(blocks[k:k + m["shape"][0]]))
                k += m["shape"][0]
            else:
                leaves.append(blocks[k])
                k += 1
        t2 = time.perf_counter()
        self.timings = {"restore_read_s": t1 - t0,
                        "restore_exchange_s": t2 - t1,
                        "restore_sent_bytes": sent, "restore_s": t2 - t0}
        return _rebuild(tree_like, iter(leaves)), step
