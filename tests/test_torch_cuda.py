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


# -- streaming, chaos and elastic re-ranking on the card -----------------------


def test_compact_carry_and_restack_on_the_card_equal_the_cpu_port(card):
    """The carry's stable compaction and a hop checkpoint's snapshot and
    restore onto 4 and 2 ranks give the CPU port's tensors, bit for bit,
    and the restored tensors live on the card."""
    from repro_torch.sphere.chaos import HopCheckpoint
    from repro_torch.sphere.dataflow import _compact_carry
    rng = np.random.default_rng(8)
    rec = {"key": torch.from_numpy(rng.integers(-5, 1 << 20, (8, 50_000))
                                   .astype(np.int32)),
           "value": torch.from_numpy(rng.random((8, 50_000, 3))
                                     .astype(np.float32))}
    valid = torch.from_numpy(rng.random((8, 50_000)) < 0.4)
    out = {}
    for dev in ("cpu", "cuda"):
        r = {k: v.to(dev) for k, v in rec.items()}
        c_rec, c_valid, dropped = _compact_carry(r, valid.to(dev), 16_384)
        ck = HopCheckpoint.snapshot(c_rec, c_valid, hop=3, dropped=0)
        restacked = [ck.restore(Ranks(w, device=dev), ("data",))
                     for w in (4, 2)]
        for rr, vv in restacked:
            assert vv.device.type == dev
            assert all(t.device.type == dev for t in rr.values())
        out[dev] = (c_rec, c_valid, int(dropped), ck.payload, restacked)
    (cr, cv, cd, cp, cs), (gr, gv, gd, gp, gs) = out["cpu"], out["cuda"]
    assert cd == gd > 0
    assert torch.equal(cv, gv.cpu())
    for k in cr:
        assert torch.equal(cr[k], gr[k].cpu())
    np.testing.assert_array_equal(cp, gp)
    for (r1, v1), (r2, v2) in zip(cs, gs):
        assert torch.equal(v1, v2.cpu())
        for k in r1:
            assert torch.equal(r1[k], r2[k].cpu())


def test_small_storm_on_the_card_matches_the_cpu_port(card):
    """The stream-chaos soak at the reference's size, on the card, the
    reduce's sort pinned to K2: the CPU port's events log, snapshot and
    counters, K1 and K2 once a delivered batch."""
    from torch_stream_soak import port_soak
    cpu = port_soak(True, device="cpu", algo="radix")
    k1, k2 = partition.KERNEL.launches, radix_sort.KERNEL.launches
    gpu = port_soak(True, device="cuda", algo="radix")
    delivered = gpu["steps"]
    assert partition.KERNEL.launches - k1 == delivered
    # the carry's schema probe launches K2 once more, on one row a rank
    assert radix_sort.KERNEL.launches - k2 == delivered + 1
    assert gpu == cpu
    assert gpu["recoveries"] == 2 and gpu["cache"]["misses"] == 2


@pytest.mark.parametrize("kernel,rows,n,nd", [
    ("partition", 4, (1 << 23), 4),            # resumed flat send pack
    ("partition", 4, (1 << 24) + 4, 2),        # resumed flat regroup
    ("partition", 4, (1 << 24) + 2, 2),        # resumed (2, 2) stage B
    ("bitonic_sort", 8, (1 << 24) + 4, 0),     # resumed flat stage-2 sort
    ("bitonic_sort", 8, (1 << 24) + 2, 0),     # resumed (2, 2) stage-2 sort
    ("radix_sort", 4, (1 << 26) + 16, 0)])     # resumed wordcount reduce
def test_kernels_at_the_resumed_4_rank_shapes(card, kernel, rows, n, nd):
    """K1, K3 and K2 against their plain versions at the shapes a sort or
    a wordcount resumed on 4 ranks gives them (2^25 records or 2^26
    words)."""
    g = _gen(card, n + rows)
    if kernel == "partition":
        dest = torch.randint(0, nd + 1, (rows, n), device=card,
                             dtype=torch.int32, generator=g)
        rank, counts = partition.partition_rank(dest, nd)
        rrank, rcounts = ref.partition_rank_ref(dest, nd)
        ok = dest < nd
        assert torch.equal(counts, rcounts)
        assert torch.equal(rank[ok], rrank[ok])
        return
    keys = torch.randint(0, 1 << 20, (rows, n), device=card,
                         dtype=torch.int32, generator=g)
    keys[:, n // 4:] = 0x7FFFFFFF
    vals = torch.arange(n, dtype=torch.int32, device=card).expand(
        rows, n).contiguous()
    if kernel == "radix_sort":
        gk, gv = radix_sort.sort_kv_segments_radix(keys, vals)
        rk, rv = radix_sort.sort_kv_segments_radix_ref(keys, vals)
        assert torch.equal(gk, rk) and torch.equal(gv, rv)
        return
    gk, gv = bitonic_sort.sort_kv_segments_bitonic(keys, vals)
    rk, rv = ref.sort_kv_segments_ref(keys, vals)
    assert torch.equal(gk, rk)
    code = lambda k, v: torch.sort((k.to(torch.int64) << 32)
                                   | v.to(torch.int64), dim=-1).values
    assert torch.equal(code(gk, gv), code(rk, rv))


# -- the decoder LM stack and the serving engine --------------------------------

#: logits of the 2-layer smoke models, card against CPU: a bfloat16
#: product accumulates in another order on the card, which moves a
#: bfloat16 result by an ulp here and there; the logits are bfloat16
#: values (0.0156 apart at 2-4), so about 3 ulps (tests/test_torch_models.py
#: holds the port to the JAX package at the same 5e-2)
CARD_LOGITS_TOL = 0.05


def _smoke_grid_prefill(dev):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    from repro_torch.models.transformer import lm_forward
    cfg = dataclasses.replace(get_smoke_config("qwen2_moe_a2_7b"),
                              num_experts=16, capacity_factor=8.0)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu").to(dev)
    rk = Ranks(shape=(2, 4), axes=("data", "model"), device=dev)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32)).to(dev)
    caches = model.init_caches(2, 40, dev)
    before = partition.KERNEL.launches
    with torch.inference_mode():
        logits, caches, aux = lm_forward(params, cfg, toks, caches=caches,
                                         ranks=rk, last_only=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return cfg, logits.cpu(), caches["pos"].cpu(), aux, (
        partition.KERNEL.launches - before)


def test_smoke_grid_prefill_on_the_card_equals_the_cpu(card):
    """qwen2-moe smoke (16 experts, capacity factor 8) prefilled on the
    ``(2, 4)`` grid: every MoE layer runs the sphere dispatch with K1 on
    the card; logits within CARD_LOGITS_TOL of the CPU run, positions and
    ``moe_dropped`` exact, K1 twice a MoE layer (send pack and
    regroup)."""
    cfg, lg, pos, aux, k1 = _smoke_grid_prefill(card)
    _, lg_c, pos_c, aux_c, k1_c = _smoke_grid_prefill(torch.device("cpu"))
    v = cfg.vocab
    err = float((lg[..., :v] - lg_c[..., :v]).abs().max())
    assert err <= CARD_LOGITS_TOL, err
    assert torch.equal(pos, pos_c)
    assert float(aux["moe_dropped"]) == float(aux_c["moe_dropped"]) == 0
    assert k1 == 2 * cfg.num_layers and k1_c == 0


class _Recording:
    """Wraps an engine's ``_decode``: each step's last call is the decode
    that emits the tokens, so its logits and the slots' requests give the
    top-2 margin behind each emitted token."""

    def __init__(self, eng):
        self.eng, self.margins, self._last = eng, {}, None
        inner = eng._decode

        def decode(tokens, pos):
            logits = inner(tokens, pos)
            self._last = (logits[:, 0].float().cpu(), list(eng.active))
            return logits
        eng._decode = decode

    def run(self):
        while True:
            self._last = None
            self.eng.step()
            if self._last is not None:
                top2 = torch.topk(self._last[0], 2, dim=-1).values
                for s, req in enumerate(self._last[1]):
                    if req is not None:
                        self.margins.setdefault(req.req_id, []).append(
                            float(top2[s, 0] - top2[s, 1]))
            if not self.eng._has_pending() and not any(self.eng.active):
                return


def test_smoke_engine_on_the_card_gives_the_cpu_greedy_tokens(card):
    """tinyllama and qwen2-moe smoke, 6 requests through 2 slots: each
    request's tokens equal the CPU engine's, compared up to the first
    token whose CPU top-2 margin is under CARD_LOGITS_TOL (past a near
    tie the two may rightly part); at least a quarter of the tokens are
    compared."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    from repro_torch.serve import Request, ServeEngine
    for arch in ("tinyllama_1_1b", "qwen2_moe_a2_7b"):
        cfg = get_smoke_config(arch)
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 12)))
                   .astype(np.int32) for _ in range(6)]
        runs = []
        for dev in (torch.device("cpu"), card):
            eng = ServeEngine(model, params.to(dev), batch_slots=2,
                              max_len=32)
            reqs = [Request(i, p, max_new_tokens=8)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            rec = _Recording(eng)
            rec.run()
            runs.append((reqs, rec.margins))
        (cpu_reqs, margins), (card_reqs, _) = runs
        compared = 0
        for a, b in zip(cpu_reqs, card_reqs):
            for i, (ta, tb) in enumerate(zip(a.out_tokens, b.out_tokens)):
                if margins[a.req_id][i] < CARD_LOGITS_TOL:
                    break
                assert ta == tb, (arch, a.req_id, i)
                compared += 1
        assert compared >= 6 * 8 // 4, (arch, compared)


#: the other five families (MLA, xLSTM, Mamba2 + shared attention,
#: enc-dec, VLM)
ZOO = ("minicpm3_4b", "xlstm_125m", "zamba2_1_2b", "whisper_small",
       "internvl2_1b")
#: decoding through caches against a full forward (tests/test_models.py)
DECODE_TOL = 0.25


def _zoo_batch(cfg, dev, b=2, s=10):
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)).bfloat16()
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.img_tokens, cfg.d_model)).astype(np.float32)).bfloat16()
    return {k: v.to(dev) for k, v in batch.items()}


def _zoo_run(model, params, cfg, dev, feed=None):
    """Prefill of 10 tokens into caches of 24, then 8 decode steps fed
    ``feed``'s tokens (the CPU run's) or the run's own greedy ones.
    Returns (logits rows (B, 9, vocab) on the CPU, fed tokens, the last
    positions of every cache)."""
    from repro_torch.models import encdec
    batch = _zoo_batch(cfg, dev)
    n_pos = batch["tokens"].shape[1] + (cfg.img_tokens
                                        if cfg.family == "vlm" else 0)
    caches = model.init_caches(2, n_pos + 8, dev)
    extra = {}
    with torch.inference_mode():
        lg, caches = model.prefill(params, batch, caches)
        if cfg.family == "audio":
            extra["enc_out"] = encdec.encode(params, cfg, batch["frames"])
        rows, fed = [lg[:, -1, :cfg.vocab].float().cpu()], []
        for t in range(8):
            nxt = (feed[:, t] if feed is not None
                   else rows[-1].argmax(-1).to(torch.int32))
            fed.append(nxt)
            lg, caches = model.decode_step(params, caches, dict({
                "tokens": nxt[:, None].to(dev),
                "pos": torch.full((2, 1), n_pos + t, dtype=torch.int32,
                                  device=dev)}, **extra))
            rows.append(lg[:, -1, :cfg.vocab].float().cpu())
    leaves = [caches] if isinstance(caches, dict) else caches
    pos = [c["pos"].cpu() for c in leaves if "pos" in c]
    return torch.stack(rows, 1), torch.stack(fed, 1), pos, batch, extra


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_smoke_model_on_the_card_equals_the_cpu(card, arch):
    """Each of the five smoke models on the card, on the CPU port's
    weights: the prefill and 8 decode steps (fed the CPU's greedy tokens)
    within CARD_LOGITS_TOL of the CPU run, cache positions exact; and on
    the card, decoding through the caches gives a full forward's tokens
    wherever its top-2 margin exceeds DECODE_TOL."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build, encdec, transformer
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    want, fed, pos_c, _, _ = _zoo_run(model, params, cfg,
                                      torch.device("cpu"))
    params = params.to(card)
    got, _, pos, batch, extra = _zoo_run(model, params, cfg, card, feed=fed)
    err = float((got - want).abs().max())
    assert err <= CARD_LOGITS_TOL, (arch, err)
    assert all(torch.equal(a, b) for a, b in zip(pos, pos_c))
    toks = torch.cat([batch["tokens"], fed.to(card)], 1)
    with torch.inference_mode():
        if cfg.family == "audio":
            full, _ = encdec.decode_stack(params, cfg, toks, extra["enc_out"])
        else:
            full, _, _ = transformer.lm_forward(
                params, cfg, toks, img_embeds=batch.get("img_embeds"))
    full = full[:, -9:, :cfg.vocab].float().cpu()
    top2 = torch.topk(full, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > DECODE_TOL
    assert bool((full.argmax(-1) == got.argmax(-1))[clear].all()), arch
    assert float((full - got).abs().max()) < DECODE_TOL, arch


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_smoke_engine_on_the_card_gives_the_cpu_greedy_tokens(card,
                                                                   arch):
    """6 requests through 2 slots (frames for whisper): each request's
    tokens equal the CPU engine's up to the first token whose CPU top-2
    margin is under CARD_LOGITS_TOL; at least a quarter compared."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    from repro_torch.serve import Request, ServeEngine
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    traffic = []
    for _ in range(6):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(4, 12)))
        frames = (rng.standard_normal((cfg.enc_seq, cfg.d_model)).astype(
            np.float32) if cfg.family == "audio" else None)
        traffic.append((prompt.astype(np.int32), frames))
    runs = []
    for dev in (torch.device("cpu"), card):
        eng = ServeEngine(model, params.to(dev), batch_slots=2, max_len=32)
        reqs = [Request(i, p, max_new_tokens=8, frames=f)
                for i, (p, f) in enumerate(traffic)]
        for r in reqs:
            eng.submit(r)
        rec = _Recording(eng)
        rec.run()
        runs.append((reqs, rec.margins))
    (cpu_reqs, margins), (card_reqs, _) = runs
    compared = 0
    for a, b in zip(cpu_reqs, card_reqs):
        for i, (ta, tb) in enumerate(zip(a.out_tokens, b.out_tokens)):
            if margins[a.req_id][i] < CARD_LOGITS_TOL:
                break
            assert ta == tb, (arch, a.req_id, i)
            compared += 1
    assert compared >= 6 * 8 // 4, (arch, compared)


def test_model_init_without_a_card_raises(monkeypatch):
    """``build(cfg).init()`` draws on the card by default; without one it
    raises, never falling back to the CPU (runs with or without a card)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    model = build(get_smoke_config("tinyllama_1_1b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        model.init()
    with pytest.raises(RuntimeError, match="is_available"):
        model.init_caches(2, 8)


# -- training (phase 14's paths at smoke size) ---------------------------------


def _train_state(dev, arch="tinyllama_1_1b", **replace):
    """A smoke model's training form drawn on the CPU from seed 0 and put
    on ``dev`` (the same weights on both), its AdamW state, the model."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    from repro_torch.models.convert import named_leaves
    from repro_torch.train.optimizer import init_opt_state
    cfg = dataclasses.replace(get_smoke_config(arch), **replace)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu",
                        dtype=torch.float32).to(dev)
    return model, params, init_opt_state(named_leaves(params, cfg))


def _train_batch(vocab, shape=(4, 32), seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (shape[0], shape[1] + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())}


def test_smoke_train_step_on_the_card_equals_the_cpu(card):
    """One train step of smoke TinyLlama on the card and on the CPU from
    the same state and batch: the loss within CARD_LOGITS_TOL, every
    parameter within 2 lr (AdamW's first step moves a weight by
    ``lr * sign(g)``; a gradient that rounds to the other sign moves it by
    2 lr) and 99% of them equal to 1e-6."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import build_train_step
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    out = []
    for dev in (card, torch.device("cpu")):
        model, params, opt = _train_state(dev)
        step = build_train_step(model, opt_cfg)
        batch = {k: v.to(dev) for k, v in
                 _train_batch(model.cfg.vocab).items()}
        _, opt, metrics = step(params, opt, batch)
        out.append((float(metrics["loss"]),
                    {n: p.detach().cpu() for n, p in
                     params.named_parameters()}))
    (loss_card, p_card), (loss_cpu, p_cpu) = out
    assert abs(loss_card - loss_cpu) <= CARD_LOGITS_TOL
    diffs = torch.cat([(p_card[n] - p_cpu[n]).abs().flatten()
                       for n in p_cpu])
    assert float(diffs.max()) <= 2 * opt_cfg.lr * 1.0001
    assert float((diffs <= 1e-6).float().mean()) >= 0.99


def test_grid_train_step_on_the_card_runs_k1_four_times_a_layer(card):
    """qwen2-moe smoke (16 experts) on the card's ``(2, 4)`` grid: the
    remat recompute runs each MoE layer's send pack and regroup again, so
    K1 launches 4 times a layer; the routed experts get no gradient; the
    loss within CARD_LOGITS_TOL of the CPU run."""
    from repro_torch.train.trainer import loss_and_grads
    out = []
    for dev in (card, torch.device("cpu")):
        model, params, _ = _train_state(dev, "qwen2_moe_a2_7b",
                                        num_experts=16)
        rk = Ranks(shape=(2, 4), axes=("data", "model"), device=dev)
        batch = {k: v.to(dev) for k, v in
                 _train_batch(model.cfg.vocab, (4, 16)).items()}
        before = partition.KERNEL.launches
        loss, _, grads = loss_and_grads(model, params, batch, rk)
        out.append((float(loss), partition.KERNEL.launches - before,
                    grads))
    (loss_card, k1, grads), (loss_cpu, k1_cpu, _) = out
    assert k1 == 4 * model.cfg.num_layers and k1_cpu == 0
    assert abs(loss_card - loss_cpu) <= CARD_LOGITS_TOL
    for name, g in grads.items():
        routed = name.split(".")[-1] in ("w_gate", "w_up", "w_down")
        assert (g is None) == routed, name


def test_checkpoint_roundtrip_from_the_card(card, tmp_path):
    """A train state on the card saved to Sector and restored onto the
    card: equal to the bit; its slices are the same bytes as the same
    state's saved from the CPU."""
    from repro_torch.launch.train import make_sector
    from repro_torch.models.convert import flatten
    from repro_torch.train.checkpoint import SectorCheckpointer
    from repro_torch.train.trainer import state_tree
    _, client, _ = make_sector(str(tmp_path))
    md5s = []
    for dev, prefix in ((card, "/ck/card"), (torch.device("cpu"), "/ck/cpu")):
        model, params, opt = _train_state(dev)
        tree = state_tree(model, params, opt)
        ck = SectorCheckpointer(client, prefix, num_slices=3)
        ck.save(4, tree, blocking=dev.type == "cpu")
        ck.wait()
        md5s.append([fm.md5 for fm in sorted(client.ls(prefix + "/"),
                                             key=lambda fm: fm.path)
                     if "slice" in fm.path])
        if dev.type == "cuda":
            back, step = ck.restore(tree, device=dev)
            assert step == 4
            for a, b in zip(flatten(tree["params"]).values(),
                            flatten(back["params"]).values()):
                assert b.device.type == "cuda" and torch.equal(a, b)
            assert torch.equal(back["opt"]["step"], opt["step"])
    assert md5s[0] == md5s[1] and len(md5s[0]) == 3


# -- ProcessRanks on the card: two gloo processes on one card, one NCCL rank --


def _card_ranks_paths(ranks, keys, payload, value):
    """Collectives, a flat Terasort and the ``(dc, node)``-free record sort
    on the card, with K1/K3 launches counted from zero for each sort."""
    import torch_dist_paths as paths
    out = {"coll": paths.collectives(ranks)}
    for name, run in (("terasort", lambda: paths.flat_terasort(
            ranks, keys, payload)), ("records", lambda: paths.record_sort(
                ranks, keys[:value.shape[0]], value))):
        ranks.collectives.clear()
        before = {k.name: k.launches for k in (partition.KERNEL,
                                                 bitonic_sort.KERNEL)}
        out[name] = run()
        out[name]["launches"] = {
            k.name: k.launches - before[k.name]
            for k in (partition.KERNEL, bitonic_sort.KERNEL)}
        out[name]["device"] = str(ranks.device)
    return out


@pytest.fixture(scope="module")
def card_ranks():
    """Two gloo processes on ``cuda:0`` (one spawn) and the stacked
    ``Ranks(2)`` on the card, on the same seeded inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from repro_torch.comm import spawn_ranks
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2**31 - 2, size=1 << 16).astype(np.int32)
    payload = np.arange(keys.size, dtype=np.int32)
    value = rng.integers(0, 256, size=(1 << 13, 96)).astype(np.uint8)
    procs = spawn_ranks(_card_ranks_paths, (2,), backend="gloo",
                        device="cuda", timeout_s=300,
                        args=(keys, payload, value))
    stacked = _card_ranks_paths(Ranks(2, device="cuda"), keys, payload, value)
    return procs, stacked


@pytest.mark.parametrize("op", ["all_to_all", "psum", "psum_f32",
                                "all_gather", "axis_index",
                                "all_to_all_data", "psum_data",
                                "axis_index_data"])
def test_process_ranks_collectives_on_the_card(card_ranks, op):
    procs, stacked = card_ranks
    want = stacked["coll"][op]
    got = [p["coll"][op] for p in procs]
    if op in ("psum", "psum_f32", "all_gather", "psum_data"):
        for g in got:
            torch.testing.assert_close(g, want, rtol=1e-6 if op.endswith(
                "f32") else 0, atol=0)
    else:
        got = torch.cat(got)
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    assert all(p["coll"]["counts"] == stacked["coll"]["counts"]
               for p in procs)


@pytest.mark.parametrize("path", ["terasort", "records"])
def test_process_ranks_sort_on_the_card(card_ranks, path):
    """Both processes ran on ``cuda:0``, launched K1 and K3 as often as
    the stacked run, and their rows equal the stacked rows (keys in order,
    each payload beside its key)."""
    procs, stacked = card_ranks
    want = stacked[path]
    kf, pf = ("keys", "payload") if path == "terasort" else ("key", "value")
    for p in procs:
        assert p[path]["device"] == "cuda:0"
        assert p[path]["launches"] == want["launches"]
        assert all(v > 0 for v in want["launches"].values())
        assert p[path]["counts"] == want["counts"]
        assert int(p[path]["dropped"]) == 0
    for f in (kf, "valid"):
        assert torch.equal(torch.cat([p[path][f] for p in procs]), want[f])
    valid = want["valid"]
    got_p = torch.cat([p[path][pf] for p in procs])[valid]
    key = want[kf][valid]

    def multiset(k, v):
        return sorted(zip(k.tolist(), map(bytes, v.reshape(v.shape[0], -1)
                                          .numpy())))
    assert multiset(key, got_p) == multiset(key, want[pf][valid])


def _nccl_collectives(ranks):
    import torch_dist_paths as paths
    return paths.collectives(ranks)


def test_process_ranks_nccl_world_one_on_the_card(card):
    from repro_torch.comm import spawn_ranks
    (got,) = spawn_ranks(_nccl_collectives, (1,), backend="nccl",
                         device="cuda", timeout_s=180)
    import torch_dist_paths as paths
    want = paths.collectives(Ranks(1, device="cuda"))
    for k, v in want.items():
        if k == "counts":
            assert got[k] == v
        else:
            torch.testing.assert_close(got[k], v, rtol=1e-6, atol=0)


# -- training over process ranks on the card -----------------------------------


def _card_train_step(ranks, cfg, batch, opt_cfg):
    import torch_train_dist_paths as paths
    gen = torch.Generator(device=ranks.device)
    gen.manual_seed(0)
    out = paths.train_run(ranks, cfg, gen, [batch], opt_cfg)
    out["device"] = str(ranks.device)
    return out


@pytest.mark.parametrize("grid", [(1, 2), (2, 1)], ids=["model2", "data2"])
def test_process_ranks_train_step_on_the_card(card, grid):
    """Two gloo processes on ``cuda:0`` run one step of smoke TinyLlama
    with ``tp_size=2`` (heads sharded on ``(1, 2)``, the batch split on
    ``(2, 1)``) from weights drawn on the card, held to the one-process
    step on the card by ``tests/test_torch_train_dist.py``'s bounds: the
    loss within 2e-3, ``grad_norm`` within 5e-3 relative, the parameters
    by ``tests/test_torch_train.py``'s rule."""
    import dataclasses
    from repro_torch.comm import spawn_ranks
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.models import build
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import build_train_step, init_train_state
    cfg = dataclasses.replace(get_smoke_config("tinyllama_1_1b"), tp_size=2)
    block = synthetic_tokens(8 * 33, cfg.vocab).reshape(8, 33)
    batch = {"tokens": torch.from_numpy(block[:, :-1].copy()),
             "labels": torch.from_numpy(block[:, 1:].copy())}
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    res = spawn_ranks(_card_train_step, grid, ("data", "model"),
                      backend="gloo", device="cuda", timeout_s=300,
                      args=(cfg, batch, opt))
    model = build(cfg)
    gen = _gen(card, 0)
    params, state = init_train_state(model, gen, card)
    _, _, m = build_train_step(model, opt)(
        params, state, {k: v.to(card) for k, v in batch.items()})
    lr = float(m["lr"])
    for r in res:
        assert r["device"] == "cuda:0"
        assert abs(r["losses"][0] - float(m["loss"])) <= 2e-3
        assert abs(r["grad_norms"][0] - float(m["grad_norm"])) <= \
            5e-3 * float(m["grad_norm"])
        assert r["lrs"][0] == lr
    got = res[0]["params"]
    diffs = torch.cat([(got[n] - p.detach().cpu()).abs().reshape(-1)
                       for n, p in params.named_parameters()])
    assert float(diffs.max()) <= 2 * lr
    assert float(torch.quantile(diffs, 0.99)) <= 0.05 * lr
    assert float(diffs.median()) <= 0.005 * lr


@pytest.mark.parametrize("arch,grid", [("qwen2_moe_a2_7b", (1, 2)),
                                       ("minicpm3_4b", (2, 1))],
                         ids=["moe_model2", "mla_data2"])
def test_process_ranks_family_train_step_on_the_card(card, arch, grid):
    """Two gloo processes on ``cuda:0`` run one step of smoke qwen2-moe
    with 16 experts (the experts, the dispatch and the shared experts
    over ``(1, 2)``, K1 4 times a layer in each process) or smoke
    MiniCPM3 (MLA, the batch split on ``(2, 1)``) from weights drawn on
    the card, held to the stacked step on the same grid (MoE) or the
    one-process step (MLA) on the card by
    ``tests/test_torch_train_dist_families.py``'s first-step bounds: the
    loss within 2e-3, ``grad_norm`` within 5e-3 relative, the parameters
    by ``tests/test_torch_train.py``'s rule, the routed experts' decay to
    the bit."""
    import dataclasses
    import torch_train_dist_families_paths as fpaths
    from repro_torch.comm import spawn_ranks
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.models import build
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import build_train_step, init_train_state
    cfg = get_smoke_config(arch)
    moe = cfg.family == "moe"
    if moe:
        cfg = dataclasses.replace(cfg, num_experts=16)
    block = synthetic_tokens(8 * 33, cfg.vocab).reshape(8, 33)
    batch = {"tokens": torch.from_numpy(block[:, :-1].copy()),
             "labels": torch.from_numpy(block[:, 1:].copy())}
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    res = spawn_ranks(fpaths.card_step, grid, ("data", "model"),
                      backend="gloo", device="cuda", timeout_s=300,
                      args=(cfg, batch, opt))
    model = build(cfg)
    params, state = init_train_state(model, _gen(card, 0), card)
    rk = Ranks(shape=grid, axes=("data", "model"), device=card) \
        if moe else None
    _, _, m = build_train_step(model, opt, rk)(
        params, state, {k: v.to(card) for k, v in batch.items()})
    lr = float(m["lr"])
    for r in res:
        assert r["device"] == "cuda:0"
        assert abs(r["losses"][0] - float(m["loss"])) <= 2e-3
        assert abs(r["grad_norms"][0] - float(m["grad_norm"])) <= \
            5e-3 * float(m["grad_norm"])
        assert r["lrs"][0] == lr
        assert r["k1_launches"] == (4 * cfg.num_layers if moe else 0)
    got = res[0]["params"]
    want = {n: p.detach().cpu() for n, p in params.named_parameters()}
    diffs = torch.cat([(got[n] - w).abs().reshape(-1)
                       for n, w in want.items()])
    assert float(diffs.max()) <= 2 * lr
    assert float(torch.quantile(diffs, 0.99)) <= 0.05 * lr
    assert float(diffs.median()) <= 0.005 * lr
    routed = [n for n in want if moe and n.split(".")[-1] in
              ("w_gate", "w_up", "w_down")]
    assert len(routed) == (3 * cfg.num_layers if moe else 0)
    for n in routed:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.parametrize("arch,grid", [("xlstm_125m", (1, 2)),
                                       ("xlstm_125m", (2, 1)),
                                       ("zamba2_1_2b", (1, 2)),
                                       ("zamba2_1_2b", (2, 1))],
                         ids=["xlstm_model2", "xlstm_data2",
                              "zamba2_model2", "zamba2_data2"])
def test_process_ranks_ssm_train_step_on_the_card(card, arch, grid):
    """Two gloo processes on ``cuda:0`` run one step of smoke xLSTM
    (mLSTM and sLSTM) or smoke zamba2 (Mamba2 and the shared attention
    block) from weights drawn on the card, the heads over ``(1, 2)`` or
    the batch over ``(2, 1)``, held to the one-process step on the card
    by ``tests/test_torch_train_dist_ssm.py``'s bounds: the loss within
    2e-3, ``grad_norm`` within 5e-3 relative, the parameters by
    ``tests/test_torch_train.py``'s rule; no kernel launches."""
    import torch_train_dist_families_paths as fpaths
    from repro_torch.comm import spawn_ranks
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.models import build
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import build_train_step, init_train_state
    cfg = get_smoke_config(arch)
    block = synthetic_tokens(8 * 33, cfg.vocab).reshape(8, 33)
    batch = {"tokens": torch.from_numpy(block[:, :-1].copy()),
             "labels": torch.from_numpy(block[:, 1:].copy())}
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    res = spawn_ranks(fpaths.card_step, grid, ("data", "model"),
                      backend="gloo", device="cuda", timeout_s=300,
                      args=(cfg, batch, opt))
    model = build(cfg)
    params, state = init_train_state(model, _gen(card, 0), card)
    _, _, m = build_train_step(model, opt)(
        params, state, {k: v.to(card) for k, v in batch.items()})
    lr = float(m["lr"])
    for r in res:
        assert r["device"] == "cuda:0"
        assert abs(r["losses"][0] - float(m["loss"])) <= 2e-3
        assert abs(r["grad_norms"][0] - float(m["grad_norm"])) <= \
            5e-3 * float(m["grad_norm"])
        assert r["lrs"][0] == lr
        assert r["k1_launches"] == 0
    got = res[0]["params"]
    diffs = torch.cat([(got[n] - p.detach().cpu()).abs().reshape(-1)
                       for n, p in params.named_parameters()])
    assert float(diffs.max()) <= 2 * lr
    assert float(torch.quantile(diffs, 0.99)) <= 0.05 * lr
    assert float(diffs.median()) <= 0.005 * lr


@pytest.mark.parametrize("arch,grid", [("whisper_small", (1, 2)),
                                       ("whisper_small", (2, 1)),
                                       ("internvl2_1b", (1, 2)),
                                       ("internvl2_1b", (2, 1))],
                         ids=["whisper_model2", "whisper_data2",
                              "internvl2_model2", "internvl2_data2"])
def test_process_ranks_encdec_vlm_train_step_on_the_card(card, arch, grid):
    """Two gloo processes on ``cuda:0`` run one step of smoke whisper (the
    encoder, causal and cross attention, a ``loss_mask`` whose unmasked
    counts differ between the data ranks) or smoke internvl2 (the image
    tokens in front of the text) from weights drawn on the card, the
    sequence-parallel attention over ``(1, 2)`` or the batch over ``(2,
    1)``, held to the one-process step on the card by
    ``tests/test_torch_train_dist_encdec.py``'s bounds: the loss within
    2e-3, ``grad_norm`` within 5e-3 relative, the parameters by
    ``tests/test_torch_train.py``'s rule."""
    import numpy as np
    import torch_train_dist_encdec_paths as epaths
    from repro_torch.comm import spawn_ranks
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.models import build
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import build_train_step, init_train_state
    cfg = get_smoke_config(arch)
    toks = synthetic_tokens(8 * 33, cfg.vocab).reshape(1, 8, 33)
    batch = {k: torch.from_numpy(v) for k, v in epaths.train_batches(
        np.random.default_rng(0), toks, cfg, 2)[0].items()}
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    res = spawn_ranks(epaths.card_step, grid, ("data", "model"),
                      backend="gloo", device="cuda", timeout_s=300,
                      args=(cfg, batch, opt))
    model = build(cfg)
    params, state = init_train_state(model, _gen(card, 0), card)
    _, _, m = build_train_step(model, opt)(
        params, state, {k: v.to(card) for k, v in batch.items()})
    lr = float(m["lr"])
    for r in res:
        assert r["device"] == "cuda:0"
        assert abs(r["losses"][0] - float(m["loss"])) <= 2e-3
        assert abs(r["grad_norms"][0] - float(m["grad_norm"])) <= \
            5e-3 * float(m["grad_norm"])
        assert r["lrs"][0] == lr
    got = res[0]["params"]
    diffs = torch.cat([(got[n] - p.detach().cpu()).abs().reshape(-1)
                       for n, p in params.named_parameters()])
    assert float(diffs.max()) <= 2 * lr
    assert float(torch.quantile(diffs, 0.99)) <= 0.05 * lr
    assert float(diffs.median()) <= 0.005 * lr
