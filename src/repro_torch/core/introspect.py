"""Collective counts of a run (port of ``repro/core/introspect.py``).

The one-wire-tensor shuffle's acceptance contract is structural — exactly
one ``all_to_all`` per flat hop, two per hierarchical hop (times
``chunks``), one per flat combine and two per hierarchical combine. The
JAX package checks it by walking the traced jaxpr. Eager PyTorch has no
trace to walk, so the port runs the function and reads how far
:attr:`repro_torch.comm.Ranks.collectives` moved: every collective of the
stacked backend adds one there.
"""

from __future__ import annotations

from typing import Callable, Dict

from repro_torch.comm import Ranks

#: collectives that move bytes between ranks (the JAX package's names).
COLLECTIVE_PRIMITIVES = (
    "all_to_all", "all_gather", "psum", "ppermute", "reduce_scatter",
    "pmax", "pmin",
)


def collective_counts(fn: Callable, *args, ranks: Ranks,
                      **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` and return, for every name in
    :data:`COLLECTIVE_PRIMITIVES`, how many such collectives it issued on
    ``ranks`` (0 when none)."""
    before = dict(ranks.collectives)
    fn(*args, **kwargs)
    return {name: ranks.collectives[name] - before.get(name, 0)
            for name in COLLECTIVE_PRIMITIVES}
