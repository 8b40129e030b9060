"""K4, the bucket histogram: the port's entry point against the JAX one.

On the CPU the port's ``kernels.ops.bucket_histogram`` takes the plain
version; the JAX ``repro.kernels.ops.bucket_histogram`` runs its Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it. Same numpy
inputs, tolerance 0 (integer counts). The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.bucket_hist import bucket_histogram_pallas
from repro_torch.kernels import bucket_hist, ops


def _jax(ids, buckets):
    return np.asarray(jops.bucket_histogram(jnp.asarray(ids), buckets))


@pytest.mark.parametrize("n", [1, 7, 128, 1000, 4096, 10_000])
@pytest.mark.parametrize("buckets", [1, 4, 17, 128, 513])
def test_bucket_histogram_matches_jax(n, buckets):
    ids = np.random.default_rng(n * 1000 + buckets).integers(
        0, buckets, size=n).astype(np.int32)
    got = ops.bucket_histogram(torch.from_numpy(ids), buckets)
    assert got.dtype == torch.int32 and got.shape == (buckets,)
    np.testing.assert_array_equal(got.numpy(), _jax(ids, buckets))
    assert int(got.sum()) == n


@pytest.mark.parametrize("buckets", [1, 4, 4096])
def test_bucket_histogram_ignores_out_of_range_ids(buckets):
    i32 = np.iinfo(np.int32)
    ids = np.array([-1, 0, 1, 5, 99, buckets, buckets - 1, i32.min, i32.max,
                    -buckets, 3, 3, 3], np.int32)
    got = ops.bucket_histogram(torch.from_numpy(ids), buckets).numpy()
    np.testing.assert_array_equal(got, _jax(ids, buckets))
    want = np.zeros(buckets, np.int64)
    for i in ids:
        if 0 <= i < buckets:
            want[i] += 1
    np.testing.assert_array_equal(got, want)


def test_bucket_histogram_exact_past_2_24():
    """A bucket counting past 2^24 stays exact (int32 counters), as the
    JAX kernel's regression test at 2^24 + 9 checks."""
    n = (1 << 24) + 9
    ids = np.zeros(n, np.int32)
    ids[:5] = 1
    want = np.asarray(bucket_histogram_pallas(jnp.asarray(ids), 4,
                                              tile=1 << 18, interpret=True))
    got = ops.bucket_histogram(torch.from_numpy(ids), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [n - 5, 5, 0, 0])


def test_bucket_histogram_stacked_rows_match_per_row_jax():
    rng = np.random.default_rng(11)
    ids = rng.integers(-3, 20, size=(5, 777)).astype(np.int32)
    got = ops.bucket_histogram(torch.from_numpy(ids), 17)
    assert got.shape == (5, 17)
    for r in range(5):
        np.testing.assert_array_equal(got[r].numpy(), _jax(ids[r], 17))
    empty = ops.bucket_histogram(torch.zeros((3, 0), dtype=torch.int32), 6)
    assert empty.shape == (3, 6) and int(empty.abs().sum()) == 0


def test_bucket_histogram_casts_ids_and_enforces_the_envelope():
    ids = torch.tensor([0, 2, 2, 7], dtype=torch.int64)
    np.testing.assert_array_equal(ops.bucket_histogram(ids, 3).numpy(),
                                  [1, 0, 2])
    before = bucket_hist.KERNEL.launches
    for bad in (0, bucket_hist.MAX_NUM_BUCKETS + 1):
        with pytest.raises(ValueError, match="envelope"):
            ops.bucket_histogram(ids, bad)
    with pytest.raises(TypeError):
        bucket_hist.bucket_histogram(ids, 3)          # the wrapper wants int32
    with pytest.raises(ValueError):
        bucket_hist.bucket_histogram(torch.zeros((2, 2, 2),
                                                 dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="CUDA"):
        bucket_hist.bucket_histogram(torch.zeros(4, dtype=torch.int32,
                                                 device="meta"), 3)
    assert bucket_hist.KERNEL.launches == before      # CPU: no launch
    assert bucket_hist.KERNEL.replaces == "src/repro/kernels/bucket_hist.py:54"


C = bucket_hist.MIN_CHUNK


@pytest.mark.parametrize("rows,n,nb,chunk,per_row", [
    # the entry point's stage-1 ids, and one long row of 256 buckets
    (8, 1 << 22, 8, 1 << 16, 64),
    (1, 1 << 25, 256, 1 << 16, 512),
    # chunk edges
    (1, 1, 1, 4, 1), (1, C - 1, 4, C, 1), (1, C, 4, C, 1),
    (1, C + 1, 17, 8196, 2), (3, 2 * C + 1, 128, 10924, 3),
    (1, 512 * C + 5, 513, C + 4, 512),
    # the envelope's edges
    (2, 70001, 1025, 14004, 5), (1, 100_000, 4096, 14288, 7),
    (65535, 3, 8, 4, 1)])
def test_hist_plan(rows, n, nb, chunk, per_row):
    plan = bucket_hist.hist_plan(rows, n, nb)
    assert plan.chunk == chunk and plan.chunk % 4 == 0
    assert plan.blocks_per_row == per_row
    assert (per_row - 1) * chunk < n <= per_row * chunk
    assert plan.blocks == per_row * rows
    assert plan.blocks <= max(bucket_hist.BLOCKS, rows)     # a bounded grid
    assert plan.threads == 256
    assert plan.smem_bytes == 4 * nb <= 16384     # one histogram a block
    # the output is zeroed by one memset, then one launch; no scratch
    assert plan.scratch_bytes == 0
    assert plan.cuda_launches == 1 and plan.memsets == 1


@pytest.mark.parametrize("rows,n,nb", [(bucket_hist.MAX_ROWS + 1, 4, 8),
                                       (1, 4, 0), (1, 4, 4097), (0, 4, 8),
                                       (1, 0, 8)])
def test_hist_plan_rejects_outside_the_envelope(rows, n, nb):
    with pytest.raises(ValueError):
        bucket_hist.hist_plan(rows, n, nb)


def test_hist_plan_constants_match_the_cuda_source():
    import re
    from pathlib import Path
    src = (Path(bucket_hist.__file__).parent / "csrc"
           / "bucket_hist.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);",
                             src).group(1))

    assert const("kThreads") == bucket_hist.THREADS
    assert const("kVec") == bucket_hist.VEC
    assert const("kBlocks") == bucket_hist.BLOCKS
    assert const("kMinChunk") == bucket_hist.MIN_CHUNK
    assert const("kCopies") == 1
    assert const("kMaxBuckets") == bucket_hist.MAX_NUM_BUCKETS
    assert "__match_any_sync" not in src
