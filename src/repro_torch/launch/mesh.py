"""Rank grids for the launchers.

Port of ``repro/launch/mesh.py``: axes ``data`` (batch parallel) and
``model`` (tensor/expert parallel), here a :class:`repro_torch.comm.Ranks`
grid of ranks stacked on one device. ``make_production_mesh`` (the
``(16, 16)`` and ``(2, 16, 16)`` meshes of the dry run) waits for
``launch/dryrun.py``.
"""

from __future__ import annotations

from repro_torch.comm import Ranks


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Ranks:
    """``Ranks(shape=(data, model), axes=("data", "model"))`` on
    ``device`` (default: the card)."""
    return Ranks(shape=(data, model), axes=("data", "model"), device=device)


def dp_axes_of(ranks: Ranks) -> tuple:
    return tuple(a for a in ("pod", "data") if a in ranks.axes)
