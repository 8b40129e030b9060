"""K2's wrapper on the CPU: the plan it hands to the C entry point, what it
rejects, and that a CPU tensor takes the plain version. The kernel itself
runs only on the card (``tests/test_torch_cuda.py``); its plain version is
held against the JAX package in ``tests/test_torch_kernels.py``."""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import radix_sort
from repro_torch.kernels.radix_sort import (MAX_ROWS, MAX_SEGMENT_LEN, TILE,
                                            radix_plan, sort_kv_segments_radix,
                                            sort_segments_radix)

CSRC = Path(radix_sort.__file__).parent / "csrc"
T = TILE


@pytest.mark.parametrize("rows,s,tiles,scratch", [
    # 64 B of tile counters + rows x 4 x 256 int32 counts
    # + rows x tiles x 256 int64 status words
    (8, (1 << 25) + 8, 4097, 64 + 8 * 4096 + 8 * 4097 * 2048),
    (8, (1 << 23) + 8, 1025, 64 + 8 * 4096 + 8 * 1025 * 2048),
    (1, 1, 1, 64 + 4096 + 2048),
    (MAX_ROWS, 3, 1, 64 + MAX_ROWS * 4096 + MAX_ROWS * 2048),
    (1, MAX_SEGMENT_LEN, 1 << 18, 64 + 4096 + (1 << 18) * 2048),
    (3, T - 1, 1, 64 + 3 * 4096 + 3 * 2048),
    (3, T, 1, 64 + 3 * 4096 + 3 * 2048),
    (3, T + 1, 2, 64 + 3 * 4096 + 3 * 2 * 2048),
    (3, 9 * T + 5, 10, 64 + 3 * 4096 + 3 * 10 * 2048)])
def test_radix_plan(rows, s, tiles, scratch):
    plan = radix_plan(rows, s)
    assert plan.tile == T == 8192
    assert plan.tiles == tiles
    assert (tiles - 1) * T < s <= tiles * T
    assert plan.scratch_bytes == scratch
    # one histogram launch and one launch a digit pass, one memset
    assert plan.cuda_launches == 5 and plan.memsets == 1
    # ping-pong: in -> tmp -> out -> tmp -> out
    assert plan.writes == ("tmp", "out", "tmp", "out")
    # keys-only calls share the plan
    assert radix_plan(rows, s, kv=False) == plan


@pytest.mark.parametrize("rows,s", [(MAX_ROWS + 1, 4), (1, 1 << 31),
                                    (0, 4), (1, 0), (MAX_ROWS + 1, 1 << 31)])
def test_radix_plan_rejects_outside_the_envelope(rows, s):
    with pytest.raises(ValueError):
        radix_plan(rows, s)


def test_plan_constants_match_the_cuda_source():
    src = (CSRC / "radix_sort.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);",
                             src).group(1))

    assert const("kThreads") * const("kItems") == TILE
    assert const("kPasses") == radix_sort.PASSES == 4
    assert const("kRadix") == 1 << radix_sort.BITS
    assert 4 * const("kHeaderInts") == radix_sort.HEADER_BYTES


def test_k2_no_longer_builds_on_the_multisplit():
    assert '#include "multisplit.cuh"' not in (
        CSRC / "radix_sort.cu").read_text()
    # neither does K1 since its own one-sweep redesign: the header is gone
    assert '#include "multisplit.cuh"' not in (
        CSRC / "partition.cu").read_text()
    assert not (CSRC / "multisplit.cuh").exists()


@pytest.mark.parametrize("kv", [True, False])
def test_cpu_call_takes_the_plain_version(monkeypatch, kv):
    calls = []
    plain = radix_sort.sort_kv_segments_radix_ref

    def spy(keys, values):
        calls.append(values is not None)
        return plain(keys, values)

    monkeypatch.setattr(radix_sort, "sort_kv_segments_radix_ref", spy)
    keys = torch.tensor([[3, -1, 3, 0, -1]], dtype=torch.int32)
    vals = torch.arange(5, dtype=torch.int32).reshape(1, 5)
    before = radix_sort.KERNEL.launches
    if kv:
        got_k, got_v = sort_kv_segments_radix(keys, vals)
        assert got_v.tolist() == [[1, 4, 3, 0, 2]]          # stable
    else:
        got_k = sort_segments_radix(keys)
    assert got_k.tolist() == [[-1, -1, 0, 3, 3]]
    assert calls == [kv]
    assert radix_sort.KERNEL.launches == before     # no kernel on the CPU
