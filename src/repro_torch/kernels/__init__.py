"""Hopper kernels and their plain PyTorch versions (port of ``repro.kernels``).

- K1 :mod:`~repro_torch.kernels.partition` — stable partition rank,
- K3 :mod:`~repro_torch.kernels.bitonic_sort` — bitonic segment sort,
- K2 :mod:`~repro_torch.kernels.radix_sort` — stable radix segment sort,
- K4 :mod:`~repro_torch.kernels.bucket_hist` — int32 bucket histogram,

each a CUDA C++ source under ``csrc/`` built at first use by
:mod:`~repro_torch.kernels.build`; :mod:`~repro_torch.kernels.ref` holds
the plain versions, :mod:`~repro_torch.kernels.ops` the entry points.
"""
