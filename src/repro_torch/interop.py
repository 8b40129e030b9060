"""Data carried between the JAX package and the port.

The system has no weights; what crosses between the two packages is data
and its layout. The JAX package holds a global array whose leading axis
is sharded contiguously over the mesh devices (device d owns rows
``[d * n_local, (d + 1) * n_local)``); the port holds the same data
rank-stacked, ``(ranks, n_local, ...)``. ``SPMDExecutor`` results are
global ``(devices * slots, ...)`` in JAX and ``(ranks, slots, ...)`` here.

Record bytes need no conversion: ``RecordCodec.encode`` gives identical
bytes in both packages.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.comm import Ranks
from repro_torch.core.records import tree_map


def to_ranks(global_np: Any, ranks: Ranks) -> torch.Tensor:
    """JAX-global array (leading axis N, contiguous shards) ->
    ``(ranks, N / ranks, ...)`` tensor on ``ranks.device``."""
    a = np.asarray(global_np)
    if a.shape[0] % ranks.world:
        raise ValueError(f"leading axis {a.shape[0]} does not shard over "
                         f"{ranks.world} ranks")
    a = a.reshape((ranks.world, a.shape[0] // ranks.world) + a.shape[1:])
    return torch.from_numpy(np.ascontiguousarray(a)).to(ranks.device)


def to_global(t: torch.Tensor) -> np.ndarray:
    """``(ranks, slots, ...)`` tensor -> the JAX-global numpy layout
    ``(ranks * slots, ...)``."""
    t = t.detach().cpu()
    return t.reshape((-1,) + tuple(t.shape[2:])).numpy()


def records_to_ranks(records: Any, ranks: Ranks) -> Any:
    """:func:`to_ranks` over every leaf of a records tree."""
    return tree_map(lambda a: to_ranks(a, ranks), records)


def splitters_to_torch(splitters: Any, device="cuda") -> torch.Tensor:
    """JAX/numpy splitters -> int32 tensor on ``device``."""
    return torch.from_numpy(np.asarray(splitters, dtype=np.int32)).to(device)


def sort_result_to_global(result) -> Dict[str, np.ndarray]:
    """A port ``SortResult`` as the JAX ``SortResult``'s numpy arrays
    (``keys``, ``payload``, ``valid`` global; ``dropped`` a scalar)."""
    return {"keys": to_global(result.keys),
            "payload": to_global(result.payload),
            "valid": to_global(result.valid),
            "dropped": np.asarray(int(result.dropped), np.int32)}
