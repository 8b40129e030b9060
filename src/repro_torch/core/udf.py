"""sphere_map: apply a User-Defined Function to every segment (paper
§3.2-3.3), stacked ranks.

Port of ``repro/core/udf.py``. "each element in the input data array is
processed independently by the same processing function using multiple
computing units" — a rank plays the SPE role and the UDF sees one rank's
segment, as under ``shard_map`` in the JAX package. The port calls the UDF
once per rank and stacks the outputs, so any UDF written for one segment
keeps its meaning; collectives inside the UDF have no counterpart here
(multi-stage programs belong in a :class:`repro_torch.sphere.dataflow.
Dataflow`).

Supports the paper's extensions: several input streams
(``sphere_map(f, [a, b], ranks)`` == ``f(A[], B[])``) and record-wise,
group-wise or whole-segment UDFs.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import torch

from repro_torch.comm import Ranks
from repro_torch.core.records import tree_flatten, tree_unflatten
from repro_torch.core.stream import SphereStream


def per_rank(fn: Callable, *trees):
    """Call ``fn`` on each rank's slice of the rank-stacked ``trees`` and
    stack what it returns: every output leaf gains a leading rank axis."""
    split = [tree_flatten(t) for t in trees]
    world = split[0][0][0].shape[0]
    outs = []
    for r in range(world):
        outs.append(tree_flatten(fn(*[
            tree_unflatten(td, [leaf[r] for leaf in leaves])
            for leaves, td in split])))
    td = outs[0][1]
    return tree_unflatten(td, [torch.stack([torch.as_tensor(o[0][i])
                                            for o in outs])
                               for i in range(len(outs[0][0]))])


def sphere_map(udf: Callable,
               streams: Union[SphereStream, Sequence[SphereStream]],
               ranks: Ranks, axis: Union[str, Sequence[str]] = "data",
               out_axis: Union[str, Sequence[str], None] = "data"
               ) -> SphereStream:
    """Run ``udf`` on each rank's segment of the input stream(s).

    Args:
      udf: function of one segment per input stream -> that segment's
        output (a tensor or tree of tensors).
      streams: one or more SphereStreams; global ones are sharded over
        ``ranks`` first.
      ranks: the ranks (the JAX function's mesh).
      axis: rank axes the streams are split over (a name or a tuple); they
        must cover every rank.
      out_axis: the same axes — the output stays split, stacked
        ``(ranks, ...)`` — or None for a replicated output (e.g. a
        segment-level reduction every rank computes alike): rank 0's
        result, as a ``P()`` output of ``shard_map`` is.
    Returns:
      SphereStream wrapping the UDF output. A record-wise UDF (each output
      leaf keeps the segment's record count) keeps the input's validity
      mask; any reshaping UDF drops it.
    """
    names = ranks.axis_names(axis)
    if ranks.axis_size(names) != ranks.world:
        raise ValueError(f"streams must be split over every rank axis "
                         f"{ranks.axes}, got {names}")
    if out_axis is not None:
        if ranks.axis_names(out_axis) != names:
            raise ValueError(f"out_axis={out_axis} must be the input axes "
                             f"{names} or None (replicated)")
    single = isinstance(streams, SphereStream)
    stream_list = [streams] if single else list(streams)
    stream_list = [s if s.ranks is not None else s.shard(ranks)
                   for s in stream_list]
    template = stream_list[0]
    if out_axis is None:
        first = [tree_unflatten(td, [leaf[0] for leaf in leaves])
                 for leaves, td in map(tree_flatten,
                                       (s.data for s in stream_list))]
        return template.with_data(udf(*first), None)
    out = per_rank(udf, *(s.data for s in stream_list))
    valid = None
    if template.valid is not None:
        seg = template.num_records // ranks.rows
        leaves = tree_flatten(out)[0]
        if leaves and all(l.dim() > 1 and l.shape[1] == seg for l in leaves):
            valid = template.valid
    return template.with_data(out, valid, ranks=ranks)

