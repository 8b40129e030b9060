"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a GPU every test here skips (decided inside the
``card`` fixture, never at import). On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Comparisons are exact (tolerance 0); the unstable bitonic sort is held to
equal keys and an equal (key, value) multiset. The grid terasort, the
wordcount and the host executor's sort over Sector files on the card must
equal the port's CPU run of the same input; the host path's device steps
(stable argsort, int32 key cast, bucket split) must equal numpy's.
"""

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.comm import Ranks
from repro_torch.core.sort import is_globally_sorted, terasort
from repro_torch.core.mapreduce import default_hash, reduce_by_key_sum
from repro_torch.kernels import (bitonic_sort, bucket_hist, partition,
                                 radix_sort, ref)
from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

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


@pytest.mark.parametrize("rows,n,num_buckets", [
    (1, 1, 1), (1, 7, 4), (8, 5000, 8), (3, 70001, 17), (2, 4097, 513),
    (1, 100_000, 4096), (4, 0, 3)])
def test_bucket_hist_kernel_matches_plain(card, rows, n, num_buckets):
    ids = torch.randint(-2, num_buckets + 2, (rows, n), device=card,
                        dtype=torch.int32, generator=_gen(card, n + 1))
    if n:
        ids[0, 0] = torch.iinfo(torch.int32).min
        ids[-1, -1] = torch.iinfo(torch.int32).max
    before = bucket_hist.KERNEL.launches
    got = bucket_hist.bucket_histogram(ids, num_buckets)
    assert bucket_hist.KERNEL.launches == before + (1 if n else 0)
    assert torch.equal(got, ref.bucket_histogram_ref(ids, num_buckets))


def test_bucket_hist_kernel_one_id_past_2_24(card):
    n = 1 << 25
    ids = torch.zeros((1, n + 5), dtype=torch.int32, device=card)
    ids[0, -5:] = 1
    got = bucket_hist.bucket_histogram(ids, 4)
    assert got.tolist() == [[n, 5, 0, 0]]


# -- K1 and K4 at their designs' edges ---------------------------------------

I32 = torch.iinfo(torch.int32)


def _profiled(call, expected, sessions=5):
    """Names of the device events one ``call()`` makes and of the CUDA
    runtime calls it makes on the host, from ``torch.profiler``, counted
    from the call's start (each session's own fill goes first: a session's
    first device event is the one most often lost). A session can lose
    device events but never adds one, so a session that does not match
    ``expected`` is followed by another."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    warm = torch.empty(1, dtype=torch.int8, device="cuda")
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            warm.fill_(1)     # the session's first event, the one most lost
            torch.cuda.synchronize()
            with record_function("held_call"):
                call()
            torch.cuda.synchronize()
        start = min(e.time_range.start for e in prof.events()
                    if e.name == "held_call")
        mine = [e for e in prof.events()
                if e.time_range.start >= start and e.name != "held_call"]
        names = [e.name for e in mine if e.device_type == DeviceType.CUDA]
        runtime = [e.name for e in mine if e.device_type == DeviceType.CPU
                   and e.name.startswith("cuda")]
        if expected(names, runtime):
            break
    return names, runtime


def _k1_held_to_plain(dest, nd):
    """K1 against its plain version: counts and in-range ranks exactly
    equal, rank 0 outside the range, the input untouched."""
    dest_in = dest.clone()
    before = partition.KERNEL.launches
    rank, counts = partition.partition_rank(dest, nd)
    torch.cuda.synchronize()
    assert partition.KERNEL.launches == before + 1
    assert torch.equal(dest, dest_in)
    rrank, rcounts = ref.partition_rank_ref(dest, nd)
    ok = (dest >= 0) & (dest < nd)
    assert torch.equal(counts, rcounts)
    assert torch.equal(rank[ok], rrank[ok])
    assert not torch.any(rank[~ok])
    return rank, counts


@pytest.mark.parametrize("nd", [1, 2, 8, 128, 256, 4096])
@pytest.mark.parametrize("edge", ["T-1", "T", "T+1", "2T+1", "9T+5"])
def test_partition_tile_and_look_back_edges(card, nd, edge):
    """Rows of one tile (T - 1, T), two, three and ten, whose look-back
    walks over earlier tiles, at the tile T of nd's form."""
    t = partition.partition_plan(1, 1, nd).tile
    s = {"T-1": t - 1, "T": t, "T+1": t + 1, "2T+1": 2 * t + 1,
         "9T+5": 9 * t + 5}[edge]
    dest = torch.randint(-2, nd + 2, (3, s), device=card, dtype=torch.int32,
                         generator=_gen(card, s + nd))
    dest[1, ::5] = nd - 1                                # a long run
    _k1_held_to_plain(dest, nd)


@pytest.mark.parametrize("nd", [8, 4096])
@pytest.mark.parametrize("kind", ["first", "last", "none", "extremes"])
def test_partition_special_rows(card, nd, kind):
    """Every id one destination (the first or the last), none in range, or
    the int32 extremes among a few in range."""
    s = 9 * partition.partition_plan(1, 1, nd).tile + 5
    dest = torch.full((2, s), {"first": 0, "last": nd - 1, "none": nd,
                               "extremes": I32.min}[kind],
                      dtype=torch.int32, device=card)
    if kind == "none":
        dest[:, ::2] = -1
        dest[:, ::3] = I32.max
    if kind == "extremes":
        dest[:, ::2] = I32.max
        dest[:, ::7] = nd // 2
    rank, counts = _k1_held_to_plain(dest, nd)
    if kind in ("first", "last"):
        assert torch.equal(rank[0], torch.arange(s, device=card,
                                                 dtype=torch.int32))


def test_partition_most_rows_and_a_count_past_2_24(card):
    dest = torch.randint(-1, 9, (65535, 3), device=card, dtype=torch.int32,
                         generator=_gen(card, 3))
    _k1_held_to_plain(dest, 8)
    n = (1 << 24) + 9
    dest = torch.zeros((1, n), dtype=torch.int32, device=card)
    dest[0, :5] = 1
    rank, counts = partition.partition_rank(dest, 4)
    assert counts.tolist() == [[n - 5, 5, 0, 0]]
    assert rank[0, -1].item() == n - 6


def test_partition_long_row_repeats_identically(card):
    """A 2^24-id row over 256 destinations ranked three times gives the
    same ranks each time: a race in the look-back would show."""
    dest = torch.randint(-1, 257, (1, 1 << 24), device=card,
                         dtype=torch.int32, generator=_gen(card, 5))
    first = _k1_held_to_plain(dest, 256)
    for _ in range(2):
        again = partition.partition_rank(dest, 256)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


@pytest.mark.parametrize("what", ["short scratch", "tile", "tiles", "right"])
def test_partition_entry_point_holds_the_plan(card, what):
    """The C entry point takes ``partition_plan``'s tile, tiles and scratch
    bytes and refuses a call whose plan differs from its own layout."""
    rows, n, nd = 2, 3 * 8192 + 1, 8
    plan = partition.partition_plan(rows, n, nd)
    dest = torch.randint(-1, nd + 1, (rows, n), device=card,
                         dtype=torch.int32, generator=_gen(card, 6))
    rank = torch.empty_like(dest)
    counts = torch.empty((rows, nd), dtype=torch.int32, device=card)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=card)
    args = (dest, rank, counts, scratch,
            plan.scratch_bytes - 8 * (what == "short scratch"), rows, n, nd,
            plan.tile // (2 if what == "tile" else 1),
            plan.tiles + (what == "tiles"))
    if what != "right":
        with pytest.raises(RuntimeError, match="partition_rank_launch"):
            partition.KERNEL.launch("partition_rank_launch", *args)
        return
    partition.KERNEL.launch("partition_rank_launch", *args)
    rrank, rcounts = ref.partition_rank_ref(dest, nd)
    ok = (dest >= 0) & (dest < nd)
    assert torch.equal(counts, rcounts) and torch.equal(rank[ok], rrank[ok])


def _k4_held_to_plain(ids, nb):
    before = bucket_hist.KERNEL.launches
    got = bucket_hist.bucket_histogram(ids, nb)
    torch.cuda.synchronize()
    assert bucket_hist.KERNEL.launches == before + 1
    assert torch.equal(got, ref.bucket_histogram_ref(ids, nb))
    return got


HC = bucket_hist.MIN_CHUNK


@pytest.mark.parametrize("nb", [1, 8, 256, 1025, 4096])
@pytest.mark.parametrize("s", [HC - 1, HC, HC + 1, 2 * HC + 1,
                               512 * HC + 5])
def test_bucket_hist_chunk_edges(card, nb, s):
    """Rows one short of, at and one past a block's chunk, of three chunks,
    and of more chunks than the bounded grid has blocks a row; rows whose
    length is no multiple of 4, so rows (and the 1-D view of the second
    row) start off a 16-byte boundary."""
    rows = 3 if s < 512 * HC else 1
    ids = torch.randint(-2, nb + 2, (rows, s), device=card, dtype=torch.int32,
                        generator=_gen(card, s + nb))
    _k4_held_to_plain(ids, nb)
    _k4_held_to_plain(ids[-1], nb)


@pytest.mark.parametrize("nb", [8, 256, 4096])
@pytest.mark.parametrize("kind", ["first", "last", "none", "extremes"])
def test_bucket_hist_special_rows(card, nb, kind):
    s = 3 * HC + 7
    ids = torch.full((2, s), {"first": 0, "last": nb - 1, "none": nb,
                              "extremes": I32.min}[kind],
                     dtype=torch.int32, device=card)
    if kind == "none":
        ids[:, ::2] = -1
        ids[:, ::3] = I32.max
    if kind == "extremes":
        ids[:, ::2] = I32.max
        ids[:, ::7] = nb // 2
    got = _k4_held_to_plain(ids, nb)
    if kind in ("first", "last"):
        assert got[:, 0 if kind == "first" else nb - 1].tolist() == [s, s]


def test_bucket_hist_most_rows_and_repeats(card):
    ids = torch.randint(-1, 9, (65535, 3), device=card, dtype=torch.int32,
                        generator=_gen(card, 7))
    _k4_held_to_plain(ids, 8)
    ids = torch.randint(0, 256, (1, 1 << 24), device=card, dtype=torch.int32,
                        generator=_gen(card, 8))
    first = _k4_held_to_plain(ids, 256)
    for _ in range(2):
        assert torch.equal(bucket_hist.bucket_histogram(ids, 256), first)


@pytest.mark.parametrize("what", ["chunk", "blocks", "right"])
def test_bucket_hist_entry_point_holds_the_plan(card, what):
    rows, n, nb = 2, 5 * HC + 3, 8
    plan = bucket_hist.hist_plan(rows, n, nb)
    ids = torch.randint(-1, nb + 1, (rows, n), device=card, dtype=torch.int32,
                        generator=_gen(card, 9))
    out = torch.empty((rows, nb), dtype=torch.int32, device=card)
    args = (ids, out, rows, n, nb, plan.chunk + 4 * (what == "chunk"),
            plan.blocks_per_row + (what == "blocks"))
    if what != "right":
        with pytest.raises(RuntimeError, match="bucket_hist_launch"):
            bucket_hist.KERNEL.launch("bucket_hist_launch", *args)
        return
    bucket_hist.KERNEL.launch("bucket_hist_launch", *args)
    assert torch.equal(out, ref.bucket_histogram_ref(ids, nb))


@pytest.mark.parametrize("kernel,rows,n,nd", [
    ("partition", 8, 1 << 20, 8), ("partition", 2, 5000, 4096),
    ("bucket_hist", 8, 1 << 20, 8), ("bucket_hist", 1, 1 << 22, 256)])
def test_launches_and_memsets_match_the_plan(card, kernel, rows, n, nd):
    """One call's CUDA launches (the device's kernel events) and memsets
    (the host's ``cudaMemsetAsync`` calls), counted by ``torch.profiler``,
    equal its plan's; no other device event comes from the call."""
    ids = torch.randint(-1, nd + 1, (rows, n), device=card, dtype=torch.int32,
                        generator=_gen(card, 10))
    if kernel == "partition":
        plan = partition.partition_plan(rows, n, nd)
        call, tag = (lambda: partition.partition_rank(ids, nd)), "k1::"
    else:
        plan = bucket_hist.hist_plan(rows, n, nd)
        call, tag = (lambda: bucket_hist.bucket_histogram(ids, nd)), "k4::"
    call()                                          # built and warm

    def as_planned(names, runtime):
        """The device's kernels and the host's memset calls as planned; the
        device's memset events are often lost, never more than planned."""
        kernels = [x for x in names if tag in x]
        memsets = [x for x in names if x.startswith("Memset")]
        other = [x for x in names if x not in kernels and x not in memsets]
        return (len(kernels) == plan.cuda_launches
                and runtime.count("cudaMemsetAsync") == plan.memsets
                and len(memsets) <= plan.memsets and not other)

    names, runtime = _profiled(call, as_planned)
    assert as_planned(names, runtime), (names, runtime)


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


T = bitonic_sort.TILE


def _bitonic_case(card, dtype, rows, s, kind, seed):
    """Keys of one kind: random (with duplicates), all equal, all the
    dtype maximum (the stage-2 padding sentinel), sorted, or reversed."""
    g = _gen(card, seed)
    if dtype == torch.float32:
        keys = torch.randn((rows, s), device=card, generator=g)
        top = float("inf")
    else:
        keys = torch.randint(-2**31, 2**31 - 1, (rows, s), device=card,
                             dtype=torch.int32, generator=g).view(dtype)
        top = -1 if dtype == torch.uint32 else 2**31 - 1
    if kind == "dups":
        keys[:, ::3] = keys[:, :1]
    elif kind == "equal":
        keys = keys[:, :1].expand(rows, s).contiguous()
    elif kind == "max":
        bits = torch.full((rows, s), top, device=card,
                          dtype=torch.float32 if dtype == torch.float32
                          else torch.int32)
        keys = bits if dtype != torch.uint32 else bits.view(torch.uint32)
    elif kind in ("sorted", "reversed"):
        keys = ref.sort_segments_ref(keys)
        if kind == "reversed":
            keys = keys.flip(-1).contiguous()
    return keys


def _held_to_plain(keys, vals):
    before = bitonic_sort.KERNEL.launches
    keys_in, vals_in = keys.clone(), vals.clone()
    bk, bv = bitonic_sort.sort_kv_segments_bitonic(keys, vals)
    bko = bitonic_sort.sort_segments_bitonic(keys)
    torch.cuda.synchronize()
    assert bitonic_sort.KERNEL.launches == before + 2
    assert torch.equal(keys.view(torch.int32), keys_in.view(torch.int32))
    assert torch.equal(vals, vals_in)                # inputs untouched
    rk, rv = ref.sort_kv_segments_ref(keys, vals)
    assert torch.equal(bk.view(torch.int32), rk.view(torch.int32))
    assert torch.equal(bko.view(torch.int32),
                       ref.sort_segments_ref(keys).view(torch.int32))
    # (key, value) multiset per row: sort both by the 64-bit (key, value)
    # code, keys in sortable-bit order
    def codes(k, v):
        kb = radix_sort.key_to_sortable_bits(k).view(torch.int32)
        c = ((kb.to(torch.int64) & 0xFFFFFFFF) << 32) | (
            v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
        return torch.sort(c, dim=-1).values
    assert torch.equal(codes(bk, bv), codes(rk, rv))


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32])
@pytest.mark.parametrize("s", [T - 1, T, T + 1, 2 * T + 1, 4 * T + 1,
                               9 * T + 5])
def test_bitonic_tile_and_pass_edges(card, dtype, s):
    """Rows at the block-sort tile's edges and with 1, 2, 3 and 4 merge
    passes (odd and even: the result comes from either scratch buffer)."""
    for kind in ("random", "dups"):
        keys = _bitonic_case(card, dtype, 3, s, kind, s)
        vals = torch.arange(3 * s, dtype=torch.int32,
                            device=card).reshape(3, s)
        _held_to_plain(keys, vals)


@pytest.mark.parametrize("kind", ["equal", "max", "sorted", "reversed"])
@pytest.mark.parametrize("s", [T, 2 * T + 1, 4 * T + 1])
def test_bitonic_special_rows(card, kind, s):
    for dtype in (torch.int32, torch.uint32, torch.float32):
        keys = _bitonic_case(card, dtype, 2, s, kind, s + 1)
        vals = torch.arange(2 * s, dtype=torch.int32,
                            device=card).reshape(2, s)
        _held_to_plain(keys, vals)


def test_bitonic_most_rows_and_the_main_path_row(card):
    keys = _bitonic_case(card, torch.int32, 65535, 3, "random", 7)
    vals = torch.arange(keys.numel(), dtype=torch.int32,
                        device=card).reshape(keys.shape)
    _held_to_plain(keys, vals)
    # the stage-2 sort input: half real keys, then the int32 maximum
    s = (1 << 23) + 8
    keys = _bitonic_case(card, torch.int32, 2, s, "random", 8)
    keys[:, 1 << 22:] = 2**31 - 1
    vals = torch.arange(s, dtype=torch.int32, device=card).expand(2, -1)
    _held_to_plain(keys, vals.contiguous())


RT = radix_sort.TILE


def _radix_held_to_plain(keys, vals):
    """K2 kv and keys-only against the plain LSD radix: key bits and
    values exactly equal (so stable), inputs untouched."""
    before = radix_sort.KERNEL.launches
    keys_in, vals_in = keys.clone(), vals.clone()
    gk, gv = radix_sort.sort_kv_segments_radix(keys, vals)
    gko = radix_sort.sort_segments_radix(keys)
    torch.cuda.synchronize()
    assert radix_sort.KERNEL.launches == before + 2
    assert torch.equal(keys.view(torch.int32), keys_in.view(torch.int32))
    assert torch.equal(vals, vals_in)                # inputs untouched
    rk, rv = radix_sort.sort_kv_segments_radix_ref(keys, vals)
    assert torch.equal(gk.view(torch.int32), rk.view(torch.int32))
    assert torch.equal(gv, rv)
    assert torch.equal(gko.view(torch.int32), rk.view(torch.int32))
    return gk, gv


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32])
@pytest.mark.parametrize("s", [RT - 1, RT, RT + 1, 2 * RT + 1, 9 * RT + 5])
def test_radix_tile_edges(card, dtype, s):
    """Rows one short of, at and one past K2's tile, and rows of several
    tiles whose look-back walks over earlier tiles."""
    for kind in ("random", "dups"):
        keys = _bitonic_case(card, dtype, 3, s, kind, s + 2)
        vals = torch.arange(3 * s, dtype=torch.int32,
                            device=card).reshape(3, s)
        _radix_held_to_plain(keys, vals)


@pytest.mark.parametrize("kind", ["equal", "max", "sorted", "reversed"])
@pytest.mark.parametrize("s", [RT, 9 * RT + 5])
def test_radix_special_rows(card, kind, s):
    for dtype in (torch.int32, torch.uint32, torch.float32):
        keys = _bitonic_case(card, dtype, 2, s, kind, s + 3)
        vals = torch.arange(2 * s, dtype=torch.int32,
                            device=card).reshape(2, s)
        _radix_held_to_plain(keys, vals)


def test_radix_wordcount_like_rows(card):
    """The wordcount's sort input: 75% of each row the int32 maximum, the
    rest Zipf word ids below 2^20, in runs as the shuffle frames them."""
    rng = np.random.default_rng(5)
    s = 40 * RT + 17
    words = ((rng.zipf(1.1, size=(4, s)) - 1) % (1 << 20)).astype(np.int32)
    keys = torch.from_numpy(words).to(card)
    run = s // 32
    for r in range(32):                  # 8 source ranks of 4 slots each
        keys[:, r * run + run // 4:(r + 1) * run] = 2**31 - 1
    vals = torch.arange(4 * s, dtype=torch.int32, device=card).reshape(4, s)
    _radix_held_to_plain(keys, vals)


def test_radix_signed_zeros_and_infinities(card):
    f = torch.tensor([0.0, -0.0, 1.0, -0.0, float("inf"), 0.0, -1.0,
                      float("-inf"), -0.0, 0.0], device=card)
    keys = f.repeat(3, 2 * RT // 10 + 1)
    vals = torch.arange(keys.numel(), dtype=torch.int32,
                        device=card).reshape(keys.shape)
    gk, _ = _radix_held_to_plain(keys, vals)
    for row in gk:                   # -0.0 (int32 bits < 0) before +0.0
        zeros = row[row == 0].view(torch.int32)
        assert zeros.numel() and torch.all(zeros[1:] >= zeros[:-1])


def test_radix_most_rows(card):
    keys = _bitonic_case(card, torch.int32, 65535, 3, "random", 11)
    vals = torch.arange(keys.numel(), dtype=torch.int32,
                        device=card).reshape(keys.shape)
    _radix_held_to_plain(keys, vals)


def test_radix_long_row_repeats_bit_identically(card):
    """A 2^24-element row sorted three times gives the same bits each time:
    a race in the look-back would show as a difference."""
    s = 1 << 24
    keys = torch.randint(0, 1 << 12, (1, s), device=card, dtype=torch.int32,
                         generator=_gen(card, 13))
    vals = torch.arange(s, dtype=torch.int32, device=card).reshape(1, s)
    first = radix_sort.sort_kv_segments_radix(keys, vals)
    for _ in range(2):
        again = radix_sort.sort_kv_segments_radix(keys, vals)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])
    rk, rv = radix_sort.sort_kv_segments_radix_ref(keys, vals)
    assert torch.equal(first[0], rk) and torch.equal(first[1], rv)


@pytest.mark.parametrize("what", ["short scratch", "tiles", "right"])
def test_radix_entry_point_holds_the_plan(card, what):
    """The C entry point takes ``radix_plan``'s tiles and scratch bytes and
    refuses a call whose plan differs from its own layout."""
    n, s = 2, 3 * RT + 1
    plan = radix_sort.radix_plan(n, s)
    tiles = plan.tiles + (what == "tiles")
    nbytes = plan.scratch_bytes - 8 * (what == "short scratch")
    keys = _bitonic_case(card, torch.int32, n, s, "random", 17)
    vals = torch.arange(n * s, dtype=torch.int32, device=card).reshape(n, s)
    out = [torch.empty_like(keys) for _ in range(4)]
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=card)
    args = (keys, vals, out[0], out[1], out[2], out[3], scratch, nbytes, n,
            s, tiles, bitonic_sort.KEY_MODES[torch.int32])
    if what != "right":
        with pytest.raises(RuntimeError, match="radix_sort_launch"):
            radix_sort.KERNEL.launch("radix_sort_launch", *args)
        return
    radix_sort.KERNEL.launch("radix_sort_launch", *args)
    rk, rv = radix_sort.sort_kv_segments_radix_ref(keys, vals)
    assert torch.equal(out[0], rk) and torch.equal(out[1], rv)


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


def test_grid_terasort_on_the_card_equals_the_cpu_port(card):
    rng = np.random.default_rng(1)
    n = 8 * 4096
    keys = rng.integers(0, 2**31 - 2, size=n).astype(np.int32)
    payload = np.arange(n, dtype=np.int32)
    results = {}
    for dev in ("cpu", "cuda"):
        rk = Ranks(shape=(2, 4), axes=("dc", "node"), device=dev)
        res = terasort(interop.to_ranks(keys, rk),
                       interop.to_ranks(payload, rk), rk, sort_algo="radix")
        assert is_globally_sorted(res, 8) and int(res.dropped) == 0
        assert rk.collectives["all_to_all"] == 2
        results[dev] = interop.sort_result_to_global(res)
    for f in ("keys", "payload", "valid"):
        np.testing.assert_array_equal(results["cuda"][f], results["cpu"][f])


def test_wordcount_on_the_card_equals_the_cpu_port(card):
    words = ((np.random.default_rng(2).zipf(1.1, size=8 * 8192) - 1)
             % 4096).astype(np.int32)

    def count(rec, valid):
        k, s, d = reduce_by_key_sum(rec["key"], rec["value"], valid,
                                    algo="radix")
        return {"key": k, "value": s}, k >= 0, d

    df = (Dataflow.source()
          .map(lambda r: {"key": r["word"], "value": r["word"] * 0 + 1})
          .shuffle(by=lambda r: default_hash(r["key"], 8), num_buckets=8)
          .reduce(count))
    out = {}
    for dev in ("cpu", "cuda"):
        rk = Ranks(8, device=dev)
        before = radix_sort.KERNEL.launches
        res = SPMDExecutor(rk).run(df, {"word": interop.to_ranks(words, rk)})
        assert radix_sort.KERNEL.launches == before + (dev == "cuda")
        assert int(res.dropped) == 0
        out[dev] = [interop.to_global(t) for t in
                    (res.valid, res.records["key"], res.records["value"])]
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(a, b)


def test_float_reduce_on_the_card_repeats_bit_identically(card):
    """Float run totals on the card: the same bits on every call (a fixed
    order of summation), the CPU port's keys, and each total within the
    worst-case float32 summation bound ``(len - 1) * 2^-24 * sum|x|`` of
    its float64 sum, on the card and on the CPU alike. One key holds half
    of row 0 (a run of 2^21)."""
    rng = np.random.default_rng(5)
    rows, n = 2, 1 << 22
    keys = rng.integers(0, 1 << 16, size=(rows, n)).astype(np.int32)
    keys[0, rng.permutation(n)[:n // 2]] = 3
    vals = (rng.standard_normal((rows, n))
            * 10.0 ** rng.integers(-3, 4, (rows, n))).astype(np.float32)
    valid = np.ones((rows, n), bool)
    args = [torch.from_numpy(a) for a in (keys, vals, valid)]
    on_card = [reduce_by_key_sum(*[a.to(card) for a in args], algo="radix")
               for _ in range(2)]
    for a, b in zip(*on_card):
        assert torch.equal(a, b)
    on_cpu = reduce_by_key_sum(*args, algo="radix")
    assert torch.equal(on_card[0][0].cpu(), on_cpu[0])
    for r in range(rows):
        k = on_cpu[0][r].numpy()
        k = k[k >= 0]
        size = np.bincount(keys[r], minlength=1 << 16)[k]
        exact = np.bincount(keys[r], weights=vals[r].astype(np.float64),
                            minlength=1 << 16)[k]
        bound = (size - 1) * 2.0 ** -24 * np.bincount(
            keys[r], weights=np.abs(vals[r].astype(np.float64)),
            minlength=1 << 16)[k]
        for got in (on_card[0][1][r].cpu().numpy(), on_cpu[1][r].numpy()):
            got = got[:k.shape[0]].astype(np.float64)
            assert np.all(np.abs(got - exact) <= bound)


# -- the host executor's device steps ------------------------------------------


def test_host_stable_argsort_on_the_card_equals_numpy(card):
    from repro_torch.sphere.dataflow import stable_argsort
    rng = np.random.default_rng(5)
    n = 70001
    f = rng.choice(np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf,
                             1.5, -1.5, 3.0], np.float32), n)
    f.view(np.uint32)[rng.random(n) < 0.05] = 0xFFC00001
    cases = [f, rng.integers(-50, 50, n).astype(np.int32),
             rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
             rng.integers(-(1 << 40), 1 << 40, n),
             rng.standard_normal(n)]
    for keys in cases:
        before = radix_sort.KERNEL.launches
        got = stable_argsort(torch.from_numpy(keys).to(card))
        k2 = keys.dtype in (np.int32, np.uint32, np.float32)
        assert radix_sort.KERNEL.launches == before + k2
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      np.argsort(keys, kind="stable"))


def test_host_int32_key_cast_on_the_card_equals_numpy(card):
    from repro_torch.sphere.dataflow import _int32_keys
    f = np.array([np.nan, -np.nan, np.inf, -np.inf, 3e9, -3e9, 2147483520.0,
                  -2147483648.0, -0.0, 1.9, -1.9, 7.0], np.float32)
    with np.errstate(invalid="ignore"):
        for keys in (f, f.astype(np.float64),
                     np.array([1 << 40, -(1 << 33) - 5, 7], np.int64)):
            got = _int32_keys(torch.from_numpy(keys).to(card))
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          keys.astype(np.int32))


def test_host_bucket_split_on_the_card_equals_numpy(card):
    from repro_torch.sphere.dataflow import _bucket_major
    rng = np.random.default_rng(6)
    n, nb = 100_003, 8
    packed = rng.integers(0, 256, size=(n, 100), dtype=np.uint8)
    ids = rng.integers(-2, nb + 2, size=n)
    before = partition.KERNEL.launches
    block, counts = _bucket_major(torch.from_numpy(packed).to(card),
                                  torch.from_numpy(ids).to(card), nb)
    assert partition.KERNEL.launches == before + 1
    want = [packed[ids == b] for b in range(nb)]
    assert counts.tolist() == [len(w) for w in want]
    np.testing.assert_array_equal(block, np.concatenate(want))
    empty, zeros = _bucket_major(torch.zeros((0, 100), dtype=torch.uint8,
                                             device=card),
                                 torch.zeros((0,), device=card), nb)
    assert empty.shape == (0, 100) and zeros.tolist() == [0] * nb
    assert partition.KERNEL.launches == before + 1


def test_host_sort_over_sector_on_the_card_equals_the_cpu_port(card,
                                                                tmp_path):
    from repro_torch.core.records import RecordCodec
    from repro_torch.launch.train import make_sector
    from repro_torch.sphere.dataflow import HostExecutor
    from repro_torch.sphere.spe import SPE
    rng = np.random.default_rng(7)
    n = 8 * 5000
    keys = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
    value = rng.integers(0, 256, size=(n, 96), dtype=np.uint8)
    codec = RecordCodec.from_fields({"key": np.int32,
                                     "value": (np.uint8, (96,))})
    blob = codec.encode({"key": keys, "value": value})
    df = Dataflow.source(codec).sort(key=lambda r: r["key"], num_buckets=8)
    out = {}
    for dev in ("cpu", "cuda"):
        master, client, daemon = make_sector(str(tmp_path / dev), 8, 2)
        client.upload_dataset("/ts/in", [s.tobytes()
                                         for s in np.split(blob, 8)])
        daemon.run_until_stable()
        spes = [SPE(i, master.slaves[i].address, master, client.session_id)
                for i in range(8)]
        k1, k2 = partition.KERNEL.launches, radix_sort.KERNEL.launches
        res = HostExecutor(master, client, spes, daemon=daemon,
                           device=dev).run(df, [f"/ts/in.{i:05d}"
                                                for i in range(8)])
        if dev == "cuda":
            assert partition.KERNEL.launches - k1 == 8
            assert radix_sort.KERNEL.launches - k2 == res.phase_times[1][
                "segments"]
            assert res.records["key"].device.type == "cuda"
        assert not res.errors and res.data_errors == 0
        out[dev] = {k: v.cpu().numpy() for k, v in res.records.items()}
    for f in ("key", "value"):
        np.testing.assert_array_equal(out["cuda"][f], out["cpu"][f])
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(out["cuda"]["key"], keys[order])
