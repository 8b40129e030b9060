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
overlapping the next steps. Re-sharding on restore (the JAX package's
``shardings=``) waits for the ``torch.distributed`` backend; ``device=``
puts the restored tree on a device.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import Stacked
from repro_torch.sector.client import SectorClient

#: the manifest's dtype names (numpy's) and torch's dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
          "int8": torch.int8, "bool": torch.bool}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


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


def _serialize_tree(tree) -> Tuple[np.ndarray, Dict]:
    """The leaves' bytes in one host buffer (uint8), and the manifest's
    leaf table. Each tensor is copied straight into its range."""
    meta, off = [], 0
    leaves = []
    for leaf in _leaves(tree):
        parts = _parts(leaf)
        leaves.append(parts)
        shape = ([len(parts)] if isinstance(leaf, Stacked) else []) \
            + list(parts[0].shape)
        nbytes = sum(p.numel() * p.element_size() for p in parts)
        meta.append({"shape": shape, "dtype": DTYPE_NAMES[parts[0].dtype],
                     "offset": off, "nbytes": nbytes})
        off += nbytes
    buf = torch.empty(off, dtype=torch.uint8)
    for parts, m in zip(leaves, meta):
        o = m["offset"]
        for p in parts:
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


def _rebuild(like, leaves: Iterator[torch.Tensor]):
    """``like``'s structure with the next leaves put in its places."""
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
    return Stacked(leaf.unbind(0)) if isinstance(like, Stacked) else leaf


class SectorCheckpointer:
    def __init__(self, client: SectorClient, prefix: str = "/ckpt",
                 num_slices: int = 8, keep: int = 3):
        self.client = client
        self.prefix = prefix.rstrip("/")
        self.num_slices = num_slices
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return f"{self.prefix}/step_{step:08d}"

    def save(self, step: int, tree, blocking: bool = True) -> None:
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

    def _upload(self, step: int, blob: np.ndarray, meta: Dict) -> None:
        d = self._step_dir(step)
        n = self.num_slices
        size = len(blob)
        per = (size + n - 1) // n if size else 1
        slice_meta = []
        for i in range(n):
            chunk = memoryview(blob[i * per:(i + 1) * per])
            fm = self.client.upload(f"{d}/slice.{i:05d}", chunk)
            slice_meta.append({"path": fm.path, "md5": fm.md5,
                               "nbytes": len(chunk)})
        manifest = dict(meta, step=step, total_bytes=size, slices=slice_meta)
        self.client.upload(f"{d}/MANIFEST.json",
                           json.dumps(manifest).encode())
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            d = self._step_dir(s)
            for fm in self.client.ls(d + "/"):
                try:
                    self.client.delete(fm.path)
                except FileNotFoundError:
                    pass

    # -- restore ----------------------------------------------------------------
    def list_steps(self) -> List[int]:
        steps = set()
        for fm in self.client.ls(self.prefix + "/"):
            parts = fm.path[len(self.prefix) + 1:].split("/")
            if parts and parts[0].startswith("step_") and \
                    parts[-1] == "MANIFEST.json":
                steps.add(int(parts[0][5:]))
        return sorted(steps)

    def restore(self, tree_like, step: Optional[int] = None,
                device=None) -> Tuple[Any, int]:
        """Rebuild the tree (structure taken from ``tree_like``, a
        :class:`Stacked` leaf coming back as one of views of the loaded
        array) on ``device`` (default: the host); verify every slice MD5.
        Returns (tree, step)."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.prefix}")
        step = steps[-1] if step is None else step
        d = self._step_dir(step)
        manifest = json.loads(self.client.download(f"{d}/MANIFEST.json"))
        blob = np.empty(manifest["total_bytes"], np.uint8)
        off = 0
        for sm in manifest["slices"]:
            chunk = self.client.download(sm["path"])
            if hashlib.md5(chunk).hexdigest() != sm["md5"]:
                raise IOError(f"checksum mismatch on {sm['path']}")
            blob[off:off + len(chunk)] = np.frombuffer(chunk, np.uint8)
            off += len(chunk)
            del chunk
        leaves = _deserialize_leaves(blob, manifest, device)
        return _rebuild(tree_like, iter(leaves)), step
