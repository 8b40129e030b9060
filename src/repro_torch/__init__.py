"""PyTorch/CUDA port of the Sector/Sphere reproduction.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``. Two executors run the
dataflow API (:mod:`repro_torch.sphere.dataflow`): ``SPMDExecutor`` runs
the Terasort main path over :class:`repro_torch.comm.Ranks`, and
``HostExecutor`` runs pipelines over files in the Sector data plane
(:mod:`repro_torch.sector`, :mod:`repro_torch.sphere.engine`), with
hand-written Hopper kernels for the partition rank, the bitonic sort, the
radix sort and the bucket histogram (:mod:`repro_torch.kernels`). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from repro_torch.comm import Ranks

__all__ = ["Ranks"]
