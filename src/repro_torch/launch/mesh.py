"""Rank grids for the launchers.

Port of ``repro/launch/mesh.py``: axes ``pod`` (the wide-area
dimension), ``data`` (batch parallel) and ``model`` (tensor/expert
parallel). :func:`make_host_mesh` is a :class:`repro_torch.comm.Ranks`
grid of ranks stacked on one device; :func:`make_production_mesh` is the
dry run's ``(16, 16)`` or ``(2, 16, 16)`` grid as data, its shape and
axes, which no rank is built for (256 or 512 ranks do not stack on one
card).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

from repro_torch.comm import Ranks


class Grid(NamedTuple):
    """A grid's shape and axis names, as a mesh has them."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def sizes(self) -> Dict[str, int]:
        """``{axis: size}``, a JAX mesh's ``shape``."""
        return dict(zip(self.axes, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Grid:
    if multi_pod:
        return Grid((2, 16, 16), ("pod", "data", "model"))
    return Grid((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Ranks:
    """``Ranks(shape=(data, model), axes=("data", "model"))`` on
    ``device`` (default: the card)."""
    return Ranks(shape=(data, model), axes=("data", "model"), device=device)


def dp_axes_of(ranks) -> tuple:
    """The batch axes of a :class:`Ranks` or a :class:`Grid`."""
    return tuple(a for a in ("pod", "data") if a in ranks.axes)
