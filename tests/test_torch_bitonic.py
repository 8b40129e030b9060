"""K3's wrapper on the CPU: the pass plan it hands to the C entry point and
what it rejects. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``); its plain version is held against the JAX
package in ``tests/test_torch_kernels.py``."""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import bitonic_sort
from repro_torch.kernels.bitonic_sort import (MAX_ROWS, TILE, pass_plan,
                                              sort_kv_segments_bitonic,
                                              sort_segments_bitonic)

T = TILE


@pytest.mark.parametrize("rows,s,tiles,passes", [
    (1, 1, 1, 0), (1, 2, 1, 0), (8, T - 1, 1, 0), (8, T, 1, 0),
    (8, T + 1, 2, 1), (8, 2 * T + 1, 3, 2), (8, 4 * T, 4, 2),
    (8, 4 * T + 1, 5, 3),
    (8, (1 << 23) + 2, 1025, 11), (8, (1 << 23) + 8, 1025, 11),
    (8, 1 << 23, 1024, 10), (MAX_ROWS, 3, 1, 0)])
def test_pass_plan(rows, s, tiles, passes):
    plan = pass_plan(rows, s)
    assert plan.tile == T
    assert plan.tiles == tiles and plan.merge_passes == passes
    # T << passes covers the row, T << (passes - 1) does not
    assert T << passes >= s and (passes == 0 or T << (passes - 1) < s)
    assert plan.chunks == -(-s // bitonic_sort.CHUNK)
    # the block sort and every merge pass but the last write scratch,
    # alternating; the last pass writes the outputs
    assert len(plan.writes) == passes + 1 and plan.writes[-1] == "out"
    assert plan.writes[:-1] == tuple(f"scratch{p % 2}" for p in range(passes))
    assert plan.scratch_buffers == min(passes, 2)
    assert plan.cuda_launches == 1 + 2 * passes
    # O(log(s / T)) launches: at most 2 ceil(log2 ceil(s / T)) + 2
    assert plan.cuda_launches <= 2 * (tiles - 1).bit_length() + 2


def test_plan_constants_match_the_cuda_source():
    src = (Path(bitonic_sort.__file__).parent / "csrc" /
           "bitonic_sort.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kSortThreads") * const("kItems") == bitonic_sort.TILE
    assert (const("kMergeThreads") * const("kMergeItems")
            == bitonic_sort.CHUNK)
    # a merge chunk never straddles a pair of runs
    assert (2 * bitonic_sort.TILE) % bitonic_sort.CHUNK == 0


@pytest.mark.parametrize("rows,s", [(MAX_ROWS + 1, 4), (1, 1 << 31),
                                    (0, 4), (1, 0)])
def test_pass_plan_rejects_outside_the_envelope(rows, s):
    with pytest.raises(ValueError):
        pass_plan(rows, s)


@pytest.mark.parametrize("keys,values,err", [
    (torch.zeros((1, 4), dtype=torch.int64), None, TypeError),
    (torch.zeros((1, 4), dtype=torch.float64), None, TypeError),
    (torch.zeros((1, 4), dtype=torch.int16), None, TypeError),
    (torch.zeros(4, dtype=torch.int32), None, ValueError),
    (torch.zeros((1, 2, 4), dtype=torch.int32), None, ValueError),
    (torch.zeros((1, 4), dtype=torch.int32),
     torch.zeros((1, 4), dtype=torch.int16), TypeError),
    (torch.zeros((1, 4), dtype=torch.int32),
     torch.zeros((1, 4), dtype=torch.int64), TypeError),
    (torch.zeros((1, 4), dtype=torch.int32),
     torch.zeros((1, 5), dtype=torch.int32), ValueError),
    (torch.zeros((2, 4), dtype=torch.int32),
     torch.zeros((1, 4), dtype=torch.int32), ValueError),
    (torch.zeros((1, 4), dtype=torch.int32),
     torch.zeros((1, 4), dtype=torch.int32, device="meta"), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(keys, values, err):
    with pytest.raises(err):
        if values is None:
            sort_segments_bitonic(keys)
        else:
            sort_kv_segments_bitonic(keys, values)
