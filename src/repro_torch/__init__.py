"""PyTorch/CUDA port of the Sector/Sphere reproduction.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``. The Terasort main path
runs here — :mod:`repro_torch.sphere.dataflow` over
:class:`repro_torch.comm.Ranks` — with hand-written Hopper kernels for the
partition rank, the bitonic sort and the radix sort
(:mod:`repro_torch.kernels`). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from repro_torch.comm import Ranks

__all__ = ["Ranks"]
