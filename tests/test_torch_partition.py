"""K1's wrapper on the CPU: the plan it hands to the C entry point, what it
rejects, and the port against ``partition_rank_pallas`` (interpret mode)
at the kernel's tile edges. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.partition import partition_rank_pallas
from repro_torch.kernels import partition
from repro_torch.kernels.partition import (MAX_NUM_DEST, MAX_ROW_LEN,
                                           MAX_ROWS, partition_plan,
                                           partition_rank)

CSRC = Path(partition.__file__).parent / "csrc"
T = 12288         # tile up to 1024 destinations (16 warps x 768 ids)
TW = 3072         # above (4 warps x 768 ids)


def _plain_scratch(rows, tiles, nd):
    # 64 B header (the tile counter) + one int64 status word per
    # (row, tile, destination)
    return 64 + 8 * rows * tiles * nd


@pytest.mark.parametrize("rows,n,nd,tile,tiles", [
    # the paths' shapes at N = 2^25 records on 8 ranks
    (8, 1 << 22, 8, T, 342),                 # send path
    (8, (1 << 23) + 8, 1, T, 683),           # flat regroup
    (8, 1 << 22, 4, T, 342),                 # grid stage A
    (8, (1 << 23) + 4, 2, T, 683),           # grid stage B
    (8, (1 << 23) + 2, 1, T, 683),           # grid regroup
    (8, 1 << 23, 8, T, 683),                 # wordcount shuffle
    # tile edges, both forms
    (3, T - 1, 256, T, 1), (3, T, 256, T, 1), (3, T + 1, 256, T, 2),
    (3, 2 * T + 1, 1024, T, 3),
    (2, TW - 1, 1025, TW, 1), (2, TW, 4096, TW, 1), (2, TW + 1, 4096, TW, 2),
    # the envelope's edges
    (MAX_ROWS, 3, 1, T, 1), (1, 1, 1, T, 1),
    (1, MAX_ROW_LEN, 8, T, 174763), (1, MAX_ROW_LEN, MAX_NUM_DEST, TW,
                                     699051)])
def test_partition_plan(rows, n, nd, tile, tiles):
    plan = partition_plan(rows, n, nd)
    assert plan.tile == tile and plan.tiles == tiles
    assert (tiles - 1) * tile < n <= tiles * tile
    assert plan.blocks == rows * tiles
    assert plan.threads == tile // 24                # 24 ids a thread
    assert plan.ballots == int(np.ceil(np.log2(nd + 1)))
    assert plan.smem_bytes == 4 * (plan.threads // 32 + 1) * nd
    assert plan.scratch_bytes == _plain_scratch(rows, tiles, nd)
    # one launch, one memset of the scratch; counts need no zeroing
    assert plan.cuda_launches == 1 and plan.memsets == 1


def test_partition_plan_fits_two_blocks_an_sm():
    """Per-warp counters and tile totals leave room for a second block (the
    H100's 227 KB a block, 228 KB an SM) in both forms."""
    for nd in (1, 8, 256, 1024, 1025, 4096):
        assert 2 * partition_plan(1, 1, nd).smem_bytes <= 228 * 1024


@pytest.mark.parametrize("rows,n,nd", [(MAX_ROWS + 1, 4, 8),
                                       (1, MAX_ROW_LEN + 1, 8), (1, 4, 0),
                                       (1, 4, MAX_NUM_DEST + 1), (0, 4, 8),
                                       (1, 0, 8)])
def test_partition_plan_rejects_outside_the_envelope(rows, n, nd):
    with pytest.raises(ValueError):
        partition_plan(rows, n, nd)


def test_plan_constants_match_the_cuda_source():
    src = (CSRC / "partition.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);",
                             src).group(1))

    assert const("kItems") == partition.ITEMS
    assert const("kNarrowWarps") == partition.NARROW_WARPS
    assert const("kWideWarps") == partition.WIDE_WARPS
    assert const("kNarrowDest") == partition.NARROW_DEST
    assert const("kMaxDest") == MAX_NUM_DEST
    assert 4 * const("kHeaderInts") == partition.HEADER_BYTES
    # one sweep: no multisplit header, no match_any
    assert "multisplit" not in src and "__match_any_sync" not in src


@pytest.mark.parametrize("n", [T - 1, T, T + 1, 2 * T + 1])
@pytest.mark.parametrize("nd", [1, 8, 256])
def test_partition_rank_matches_pallas_at_the_tile_edges(n, nd):
    rng = np.random.default_rng(n + nd)
    dest = rng.integers(-2, nd + 2, size=n).astype(np.int32)
    jr, jc = partition_rank_pallas(jnp.asarray(dest), nd, tile=4096,
                                   interpret=True)
    tr, tc = partition_rank(torch.from_numpy(dest), nd)
    ok = (dest >= 0) & (dest < nd)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr.numpy()[ok], np.asarray(jr)[ok])
    assert np.all(tr.numpy()[~ok] == 0)               # the port's contract


@pytest.mark.parametrize("n", [TW - 1, TW + 1])
def test_partition_rank_matches_pallas_at_the_wide_tile_edges(n):
    nd = 1500
    rng = np.random.default_rng(n)
    dest = rng.integers(-1, nd + 1, size=n).astype(np.int32)
    dest[::3] = nd - 1                               # a long run
    jr, jc = partition_rank_pallas(jnp.asarray(dest), nd, tile=1024,
                                   interpret=True)
    tr, tc = partition_rank(torch.from_numpy(dest), nd)
    ok = (dest >= 0) & (dest < nd)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr.numpy()[ok], np.asarray(jr)[ok])


def test_cpu_call_takes_the_plain_version(monkeypatch):
    calls = []
    plain = partition.ref.partition_rank_ref

    def spy(dest, nd):
        calls.append(nd)
        return plain(dest, nd)

    monkeypatch.setattr(partition.ref, "partition_rank_ref", spy)
    dest = torch.tensor([[3, -1, 3, 0, 7, 3]], dtype=torch.int32)
    before = partition.KERNEL.launches
    rank, counts = partition_rank(dest, 4)
    assert rank.tolist() == [[0, 0, 1, 0, 0, 2]]
    assert counts.tolist() == [[1, 0, 0, 3]]
    assert calls == [4]
    assert partition.KERNEL.launches == before     # no kernel on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        partition_rank(torch.zeros(4, dtype=torch.int32, device="meta"), 3)
    assert partition.KERNEL.replaces == "src/repro/kernels/partition.py:89"
