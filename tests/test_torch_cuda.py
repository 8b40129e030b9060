"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a GPU every test here skips (decided inside the
``card`` fixture, never at import). On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Comparisons are exact (tolerance 0); the unstable bitonic sort is held to
equal keys and an equal (key, value) multiset.
"""

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.comm import Ranks
from repro_torch.core.sort import is_globally_sorted, terasort
from repro_torch.kernels import bitonic_sort, partition, radix_sort, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("rows,n,num_dest", [(1, 1, 1), (8, 5000, 8),
                                             (3, 70001, 9), (17, 33, 4096)])
def test_partition_rank_kernel_matches_plain(card, rows, n, num_dest):
    dest = torch.randint(-2, num_dest + 2, (rows, n), device=card,
                         dtype=torch.int32, generator=_gen(card, n))
    before = partition.KERNEL.launches
    rank, counts = partition.partition_rank(dest, num_dest)
    assert partition.KERNEL.launches == before + 1
    rrank, rcounts = ref.partition_rank_ref(dest, num_dest)
    ok = (dest >= 0) & (dest < num_dest)
    assert torch.equal(counts, rcounts)
    assert torch.equal(rank[ok], rrank[ok])


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32])
@pytest.mark.parametrize("rows,s", [(1, 2), (3, 1000), (5, 4097),
                                    (2, 70001)])
def test_sort_kernels_match_plain(card, dtype, rows, s):
    g = _gen(card, rows * s)
    if dtype == torch.float32:
        keys = torch.randn((rows, s), device=card, generator=g)
    else:
        keys = torch.randint(-2**31, 2**31 - 1, (rows, s), device=card,
                             dtype=torch.int32, generator=g).view(dtype)
    vals = torch.arange(rows * s, dtype=torch.int32,
                        device=card).reshape(rows, s)
    rk, rv = ref.sort_kv_segments_ref(keys, vals)
    gk, gv = radix_sort.sort_kv_segments_radix(keys, vals)
    pk, pv = radix_sort.sort_kv_segments_radix_ref(keys, vals)
    assert torch.equal(gk.view(torch.int32), pk.view(torch.int32))
    assert torch.equal(gv, pv)
    bk, bv = bitonic_sort.sort_kv_segments_bitonic(keys, vals)
    assert torch.equal(bk.view(torch.int32), rk.view(torch.int32))
    for r in range(rows):
        got = sorted(zip(bk[r].view(torch.int32).tolist(), bv[r].tolist()))
        want = sorted(zip(rk[r].view(torch.int32).tolist(), rv[r].tolist()))
        assert got == want


def test_terasort_on_the_card_equals_the_cpu_port(card):
    rng = np.random.default_rng(0)
    n = 8 * 4096
    keys = rng.integers(0, 2**31 - 2, size=n).astype(np.int32)
    payload = np.arange(n, dtype=np.int32)
    results = {}
    for dev in ("cpu", "cuda"):
        rk = Ranks(8, device=dev)
        res = terasort(interop.to_ranks(keys, rk),
                       interop.to_ranks(payload, rk), rk, sort_algo="radix")
        assert is_globally_sorted(res, 8) and int(res.dropped) == 0
        results[dev] = interop.sort_result_to_global(res)
    for f in ("keys", "payload", "valid"):
        np.testing.assert_array_equal(results["cuda"][f], results["cpu"][f])
