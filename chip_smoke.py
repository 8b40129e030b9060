#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU.

    python3 chip_smoke.py                 # N = 2^25 100-byte records
    python3 chip_smoke.py --n-log2 20     # a quick, smaller run
    python3 chip_smoke.py --profile DIR   # + a profiled warm rerun of each
                                          #   path, traces written to DIR

Phases, in order (any failure ends the script with a non-zero exit):

1. the card's name and power limit (``nvidia-smi``);
2. build the Hopper kernels K1 (partition rank), K3 (bitonic sort), K2
   (radix sort) and K4 (bucket histogram) from
   ``src/repro_torch/kernels/csrc`` with ``nvcc``, all at once, printing
   seconds and the ``-Xptxas -v`` lines;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the paths below give it and at edge cases, and time kernel,
   plain version and the nearest single PyTorch call (CUDA events, median
   of 10 warm runs) beside the memory bound. K3 also at its design's
   edges (rows of T - 1, T, T + 1 for its 8192-element tile, 1 to 4
   merge passes, all-equal, all-maximum, sorted and reversed rows, 65535
   rows of 3), keys-only against ``ref.sort_segments_ref``, timed on
   random keys and on the main path's own stage-2 sort input at the flat
   and the grid shape, with its CUDA launches per call counted by
   ``torch.profiler``. K2 also at its design's edges (rows of T - 1, T,
   T + 1, 2 T + 1 and 9 T + 5 for its 8192-element tile, all-equal,
   all-maximum, sorted and reversed rows, a wordcount-like row, 65535
   rows of 3, keys-only, inputs untouched, and a 2^24-element row sorted
   three times bit-identically), timed at (8, 2^25 + 8) and (8, 2^23 + 8)
   with its CUDA launches and memsets per call counted by
   ``torch.profiler`` and held to ``radix_plan``; its phase line also
   gives the time its design's 68 B/element would take at the card's
   memory rate (computed like the bound, not measured; it stays out of
   the kernel table). K1 also at its tile's edges in both forms (T - 1
   to 9 T + 5 for 1 to 4096 destinations), one destination for all, none
   in range, the int32 extremes, 65535 rows, a count past 2^24 and a
   2^24-id row ranked three times identically, timed at each of its six
   path shapes; K4 at its chunk's edges, with rows and 1-D views that
   start off a 16-byte boundary, timed at (8, 2^22) with 8 buckets and
   (1, 2^25) with 256. For K1, K2 and K4 the CUDA launches and memsets
   of one call are counted by ``torch.profiler`` and held to the plan,
   and the profiler's kernel and memset time of a call is given beside
   the CUDA-event window, so that host time inside the window shows;
4. K4's path, its entry point ``kernels.ops.bucket_histogram`` (on no
   dataflow path, as in the JAX package), on the main path's stage-1
   bucket ids;
5. the main path: ``Dataflow.source().sort(...)`` over 8 stacked ranks of
   100-byte records ``{"key": int32, "value": uint8[96]}``, bitonic
   pinned; checks a globally sorted permutation with every value row
   still beside its key and no drops, and that K1 and K3 ran;
6. the wide-area path: the same pipeline and records on the ``(dc, node)
   = (2, 4)`` grid of ranks (the two-level hierarchical shuffle); the
   same checks, the same sorted keys as phase 5, K1 3 times, K3 once, two
   ``all_to_all``; cold and warm wall time and the WAN profile of both
   plans;
7. MapReduce wordcount: ``map -> shuffle(default_hash) ->
   reduce(reduce_by_key_sum(algo="radix"))`` over 8 ranks on 2^(n+1)
   Zipf(1.1) word ids in a 2^20-word vocabulary; every (word, count) must
   equal ``np.bincount`` of the input, and K2 must run (radix is pinned,
   so the path always measures K2); K2 is then held against its plain
   version and timed on the reduce's own sort input, beside the library
   call and its bound;
8. the ``terasort()`` shim three ways — ``sort_algo="radix"`` (K2 must
   run), ``buckets_per_device=4``, and ``hadoop_style_sort`` against
   ``terasort`` — and the autotuner's choice for the main-path cell;
9. the host path: Terasort over Sector files. ``make_sector`` builds 8
   slaves in a temporary directory on the local disk (removed at the
   end), replication 2 with the ``ReplicationDaemon``; phase 5's records
   are uploaded as 8 slices, and 8 SPEs run
   ``Dataflow.source(codec).sort(key, num_buckets=8)``
   through ``HostExecutor`` on the card: phase 0 splits each slice into
   bucket files with K1, phase 1 sorts each bucket file with K2. Checks a
   globally sorted permutation with each value row beside its key, keys
   equal to ``torch.sort`` of the input's and to phase 5's, no errors, K1 once per phase-0 segment and K2 once per phase-1
   bucket file; prints cold and warm wall, records/s, the per-phase
   split, the slaves' write, md5 and ``used_bytes`` seconds of the warm
   run, disk bytes written and peak device memory (``--profile``: the
   device busy share of a warm run); holds K1 and K2 to their plain
   versions at this path's shapes; then sorts a 2^20-record prefix again
   with one SPE crashing after its first segment (same output, retries
   > 0).

Each path's launch counts are read from zero: every count is reset just
before the path runs and read just after. The last lines are the kernel
table as one JSON object, the ``nvidia-smi`` name/power line, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
WORLD = 8
GRID = (2, 4)                # the wide-area (dc, node) grid of the 8 ranks
VALUE_BYTES = 96             # + the 4-byte key = one 100-byte record
VOCAB = 1 << 20              # wordcount vocabulary
ZIPF_A = 1.1
TIMED_ITERS = 10
#: bytes a kv element moves through K2's one-sweep design: 4 for the
#: histogram's read of the keys, 16 in each of the 4 digit passes
K2_BYTES_PER_KV = 4 + 4 * 16


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = TIMED_ITERS) -> float:
    """Median device time of ``fn`` in ms (CUDA events, 2 warm-up runs)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


class Check:
    """Collects one kernel's comparison against its plain version."""

    def __init__(self, name: str):
        self.name = name
        self.max_abs_err = 0
        self.cases = 0

    def equal(self, what: str, got, want, mask=None) -> None:
        """Exact comparison (tolerance 0: all data here is integer or a
        permutation of the input); records the max |got - want|."""
        import torch
        if got.shape != want.shape:
            raise AssertionError(f"{self.name} {what}: shape {tuple(got.shape)}"
                                 f" != {tuple(want.shape)}")
        a, b = as_wide(got), as_wide(want)
        diff = torch.where(a == b, 0, (a - b).abs())    # inf == inf
        if mask is not None:
            diff = diff[mask]
        err = diff.max().item() if diff.numel() else 0
        if err != 0:
            raise AssertionError(f"{self.name} {what}: max |kernel - plain| "
                                 f"= {err} (tolerance 0)")
        self.max_abs_err = max(self.max_abs_err, err)
        self.cases += 1


def as_wide(t):
    """float64 for float keys (so -0.0 == +0.0), exact int64 otherwise."""
    import torch
    if t.dtype.is_floating_point:
        return t.to(torch.float64)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


# -- phase 3: kernels against their plain versions ------------------------------


def pairs_sorted(torch, keys, vals):
    """Each row's multiset of (key, value) pairs as sorted int64 codes
    (key in sortable-bit order, then payload bits). K3 pads nothing in
    memory, so pairs keyed by the dtype maximum are compared too."""
    from repro_torch.kernels.radix_sort import key_to_sortable_bits
    kb = key_to_sortable_bits(keys).view(torch.int32).to(torch.int64)
    kb = kb & 0xFFFFFFFF
    code = (kb << 32) | (vals.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
    return torch.sort(code, dim=-1).values


def make_keys(torch, gen, shape, dtype, dev):
    if dtype == torch.float32:
        return torch.randn(shape, generator=gen, device=dev)
    bits = torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=gen,
                         device=dev, dtype=torch.int32)
    return bits if dtype == torch.int32 else bits.view(torch.uint32)


class Shapes:
    """The shapes each path gives the kernels, from the record counts."""

    def __init__(self, n_log2: int):
        self.n = 1 << n_log2
        self.n_local = self.n // WORLD
        cap = int(self.n_local / WORLD * 2.0) + 1
        self.recv = WORLD * cap                   # flat stage-2 segment
        dcs, nodes = GRID
        self.cap_a = int(self.n_local / nodes * 2.0) + 1
        self.cap_b = int(self.n_local / dcs * 2.0) + 1
        self.staged = nodes * self.cap_a          # stage-B send rows
        self.recv_grid = dcs * self.cap_b         # grid stage-2 segment
        self.words = 2 * self.n                   # wordcount input
        self.words_local = self.words // WORLD
        # the shuffle stage's default capacity_factor is 4
        self.wc_recv = WORLD * (int(self.words_local / WORLD * 4.0) + 1)


def k1_path_shapes(sh: Shapes):
    """(where, rows x ids, destinations) of every K1 launch on the paths."""
    return [("flat send pack", (WORLD, sh.n_local), WORLD),
            ("flat stage-2 regroup", (WORLD, sh.recv), 1),
            ("grid stage A (node hop)", (WORLD, sh.n_local), GRID[1]),
            ("grid stage B (dc hop)", (WORLD, sh.staged), GRID[0]),
            ("grid stage-2 regroup", (WORLD, sh.recv_grid), 1),
            ("wordcount shuffle", (WORLD, sh.words_local), WORLD)]


def check_partition(torch, dev, gen, sh: Shapes):
    """K1 against its plain version, tolerance 0: the paths' shapes, its
    tile's edges in both forms (12288 ids up to 1024 destinations, 3072
    above), one destination for all, none in range, the int32 extremes,
    65535 rows, a count past 2^24 and a long row ranked three times
    identically. Timed at every path shape beside its bound, with its
    launches and memsets held to ``partition_plan``."""
    from repro_torch.kernels import partition, ref
    chk = Check("partition_rank")
    i32 = torch.iinfo(torch.int32)

    def compare(what, dest, nd):
        rank, counts = partition.partition_rank(dest, nd)
        rrank, rcounts = ref.partition_rank_ref(dest, nd)
        ok = (dest >= 0) & (dest < nd)
        chk.equal(f"counts {what} D={nd}", counts, rcounts)
        chk.equal(f"rank {what} D={nd}", rank, rrank, mask=ok)
        chk.equal(f"rank 0 out of range {what} D={nd}", rank,
                  torch.zeros_like(rank), mask=~ok)
        return rank, counts

    cases = [(shape, nd, nd + 1) for _, shape, nd in k1_path_shapes(sh)]
    cases += [((WORLD, sh.recv), 4, 5),                   # regroup, bpd = 4
              ((3, 5000), 9, 12), ((17, 33), 1, 3), ((1, 4097), 4096, 4096),
              ((2, 1), 8, 9)]
    for nd in (1, 8, 256, 1025, 4096):
        t = partition.partition_plan(1, 1, nd).tile
        cases += [((3, s), nd, nd + 2)
                  for s in (t - 1, t, t + 1, 2 * t + 1, 9 * t + 5)]
    for shape, nd, hi in cases:
        dest = torch.randint(-2, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
        compare(str(shape), dest, nd)
        del dest
    for nd in (8, 4096):
        s = 9 * partition.partition_plan(1, 1, nd).tile + 5
        for what, fill in (("all first", 0), ("all last", nd - 1),
                           ("none in range", nd), ("extremes", i32.min)):
            dest = torch.full((2, s), fill, dtype=torch.int32, device=dev)
            if what == "none in range":
                dest[:, ::2] = -1
                dest[:, ::3] = i32.max
            if what == "extremes":
                dest[:, ::2] = i32.max
                dest[:, ::7] = nd // 2
            compare(f"{what} (2, {s})", dest, nd)
    dest = torch.randint(-1, 9, (partition.MAX_ROWS, 3), generator=gen,
                         device=dev, dtype=torch.int32)
    compare(f"{partition.MAX_ROWS} rows of 3", dest, 8)
    # counts stay exact past 2^24 (a float32 accumulator would not)
    n = (1 << 24) + 9
    dest = torch.zeros((1, n), dtype=torch.int32, device=dev)
    dest[0, :5] = 1
    rank, counts = partition.partition_rank(dest, 4)
    want = torch.tensor([[n - 5, 5, 0, 0]], dtype=torch.int32, device=dev)
    chk.equal("counts past 2^24", counts, want)
    chk.equal("rank past 2^24", rank[0, -1:],
              torch.tensor([n - 6], dtype=torch.int32, device=dev))
    # a race in the look-back would show as a difference between runs
    dest = torch.randint(-1, 257, (1, 1 << 24), generator=gen, device=dev,
                         dtype=torch.int32)
    first = compare("2^24 row", dest, 256)
    for rep in (2, 3):
        again = partition.partition_rank(dest, 256)
        chk.equal(f"2^24 row, run {rep} rank", again[0], first[0])
        chk.equal(f"2^24 row, run {rep} counts", again[1], first[1])
    del dest, rank, first, again
    torch.cuda.synchronize()

    # timing at every path shape: random ids in [0, D], D standing for an
    # empty slot or the overflow destination
    shapes = []
    for where, shape, nd in k1_path_shapes(sh):
        dest = torch.randint(0, nd + 1, shape, generator=gen, device=dev,
                             dtype=torch.int32)
        plan = partition.partition_plan(*shape, nd)
        row = {"path": where, "shape": list(shape), "num_dest": nd,
               "ms": time_ms(torch,
                             lambda: partition.partition_rank(dest, nd)),
               # read ids once, write ranks and counts once
               "bound_ms": bound_ms(8 * dest.numel() + 4 * shape[0] * nd),
               "tile": plan.tile, "scratch_bytes": plan.scratch_bytes,
               **held_to_plan(torch, lambda: partition.partition_rank(dest,
                                                                      nd),
                              plan, "k1::", "K1")}
        if not shapes:      # the send path: the row of the kernel table
            offs = (torch.arange(WORLD, device=dev, dtype=torch.int32)[:, None]
                    * (nd + 1))
            row["plain_ms"] = time_ms(
                torch, lambda: ref.partition_rank_ref(dest, nd))
            row["library_ms"] = time_ms(torch, lambda: torch.bincount(
                (dest + offs).reshape(-1), minlength=WORLD * (nd + 1)))
            row["library_call"] = "torch.bincount (histogram half only)"
        shapes.append(row)
        del dest
    timing = {**shapes[0], "shapes": shapes}
    return chk, timing


def check_bucket_hist(torch, dev, gen, sh: Shapes):
    """K4 against its plain version, tolerance 0: the stage-1 shape, one
    long row, a grid of small shapes and bucket counts, its chunk's edges
    (rows whose length is no multiple of 4 and 1-D views that start off a
    16-byte boundary), one bucket for all, none in range, the int32
    extremes, 65535 rows, and one bucket counting past 2^24. Timed at both
    shapes beside its bound and ``torch.bincount``, with its launches and
    memsets held to ``hist_plan``."""
    from repro_torch.kernels import bucket_hist, ref
    chk = Check("bucket_hist")
    i32 = torch.iinfo(torch.int32)

    def compare(what, ids, nb):
        got = bucket_hist.bucket_histogram(ids, nb)
        chk.equal(what, got, ref.bucket_histogram_ref(ids, nb))

    stage1 = torch.randint(-1, WORLD, (WORLD, sh.n_local), generator=gen,
                           device=dev, dtype=torch.int32)
    compare(f"stage-1 ids {tuple(stage1.shape)} B={WORLD}", stage1, WORLD)
    long_row = torch.randint(0, 256, (1, sh.n), generator=gen, device=dev,
                             dtype=torch.int32)
    compare(f"one row {tuple(long_row.shape)} B=256", long_row, 256)
    for n in (0, 1, 7, 4097):
        for nb in (1, 4, 17, 128, 513, 4096):
            ids = torch.randint(-2, nb + 2, (2, n), generator=gen, device=dev,
                                dtype=torch.int32)
            compare(f"(2, {n}) B={nb}", ids, nb)
            compare(f"({n},) B={nb}", ids[0], nb)
    c = bucket_hist.MIN_CHUNK
    for nb in (1, 8, 256, 1025, 4096):
        for n in (c - 1, c, c + 1, 2 * c + 1, 512 * c + 5):
            rows = 3 if n < 512 * c else 1
            ids = torch.randint(-2, nb + 2, (rows, n), generator=gen,
                                device=dev, dtype=torch.int32)
            compare(f"chunk edge ({rows}, {n}) B={nb}", ids, nb)
            compare(f"chunk edge, last row as 1-D ({n},) B={nb}", ids[-1], nb)
    for nb in (1, 4, 4096):
        edge = torch.tensor([-1, nb, i32.min, i32.max, 0, nb - 1, -nb],
                            dtype=torch.int32, device=dev).repeat(3, 1000)
        compare(f"ids -1, B, INT32_MIN/MAX B={nb}", edge, nb)
        for what, fill in (("all first", 0), ("all last", nb - 1),
                           ("none in range", nb)):
            ids = torch.full((2, 3 * c + 7), fill, dtype=torch.int32,
                             device=dev)
            if what == "none in range":
                ids[:, ::2] = -1
                ids[:, ::3] = i32.max
            compare(f"{what} (2, {3 * c + 7}) B={nb}", ids, nb)
    ids = torch.randint(-1, 9, (bucket_hist.MAX_ROWS, 3), generator=gen,
                        device=dev, dtype=torch.int32)
    compare(f"{bucket_hist.MAX_ROWS} rows of 3 B=8", ids, 8)
    n = 1 << 25
    ones = torch.zeros((n + 5,), dtype=torch.int32, device=dev)
    ones[n:] = 1
    want = torch.tensor([n, 5, 0, 0], dtype=torch.int32, device=dev)
    chk.equal("2^25 zeros and five ones",
              bucket_hist.bucket_histogram(ones, 4), want)
    chk.equal("2^25 zeros and five ones (plain)",
              ref.bucket_histogram_ref(ones, 4), want)
    del ones, ids
    torch.cuda.synchronize()

    def library(ids, nb):
        """One ``torch.bincount`` over row-offset ids; ids out of range
        were moved to the spare last bin beforehand (not timed)."""
        rows = ids.shape[0]
        offs = torch.arange(rows, device=dev, dtype=torch.int32)[:, None] * nb
        flat = torch.where((ids >= 0) & (ids < nb), ids + offs,
                           rows * nb).reshape(-1)
        return lambda: torch.bincount(flat, minlength=rows * nb + 1)

    def timed(ids, nb):
        plan = bucket_hist.hist_plan(*ids.shape, nb)
        return {"shape": list(ids.shape), "num_buckets": nb,
                "ms": time_ms(torch,
                              lambda: bucket_hist.bucket_histogram(ids, nb)),
                "plain_ms": time_ms(torch,
                                    lambda: ref.bucket_histogram_ref(ids, nb)),
                "library_ms": time_ms(torch, library(ids, nb)),
                "library_call": "torch.bincount of row-offset ids",
                # read ids once, write counts once
                "bound_ms": bound_ms(4 * ids.numel() + 4 * ids.shape[0] * nb),
                "chunk": plan.chunk, "blocks": plan.blocks,
                **held_to_plan(torch,
                               lambda: bucket_hist.bucket_histogram(ids, nb),
                               plan, "k4::", "K4")}

    timing = timed(stage1, WORLD)
    timing["one_row"] = timed(long_row, 256)
    return chk, timing


def check_sort(torch, dev, gen, kernel: str, seg_lens, time_len: int,
               stage2_real: int = 0):
    """K2 or K3 against its plain version (tolerance 0) and timed.
    ``stage2_real``: for K3, the real keys per row of the main path's
    stage-2 sort input (the rest of the row is the int32 maximum)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitonic_sort import (sort_kv_segments_bitonic,
                                                  sort_segments_bitonic)
    from repro_torch.kernels.radix_sort import (sort_kv_segments_radix,
                                                sort_kv_segments_radix_ref,
                                                sort_segments_radix)
    stable = kernel == "radix_sort"
    fn = sort_kv_segments_radix if stable else sort_kv_segments_bitonic
    plain = sort_kv_segments_radix_ref if stable else ref.sort_kv_segments_ref
    chk = Check(kernel)

    def compare(what, keys, vals):
        keys_in, vals_in = keys.clone(), vals.clone()
        gk, gv = fn(keys, vals)
        rk, rv = plain(keys, vals)
        chk.equal(f"keys {what}", gk, rk)
        chk.equal(f"input keys untouched {what}", keys.view(torch.int32),
                  keys_in.view(torch.int32))
        chk.equal(f"input values untouched {what}", vals, vals_in)
        if stable:
            chk.equal(f"key bits {what}", gk.view(torch.int32),
                      rk.view(torch.int32))
            chk.equal(f"values {what}", gv, rv)
            chk.equal(f"keys-only {what}",
                      sort_segments_radix(keys).view(torch.int32),
                      rk.view(torch.int32))
        else:
            chk.equal(f"(key, value) multiset {what}",
                      pairs_sorted(torch, gk, gv), pairs_sorted(torch, rk, rv))
            chk.equal(f"keys-only {what}", sort_segments_bitonic(keys),
                      ref.sort_segments_ref(keys))

    def numbered(shape):
        return torch.arange(shape[0] * shape[1], dtype=torch.int32,
                            device=dev).reshape(shape)

    for dtype in (torch.int32, torch.uint32, torch.float32):
        for shape in ((3, 1), (17, 3), (3, 1000), (5, 4097), (2, 70001),
                      (1, 1 << 16)):
            keys = make_keys(torch, gen, shape, dtype, dev)
            compare(f"{dtype} {shape}", keys, numbered(shape))
    # duplicate runs, the dtype maximum, +-0.0 and +-inf
    dup = torch.randint(0, 4, (4, 9000), generator=gen, device=dev,
                        dtype=torch.int32)
    dup[:, ::7] = 0x7FFFFFFF
    compare("duplicates + int32 max", dup, numbered(dup.shape))
    f = torch.tensor([[0.0, -0.0, 1.0, -0.0, float("inf"), 0.0, -1.0,
                       float("-inf"), -0.0, 0.0]] * 3, device=dev)
    compare("+-0.0 and inf", f, numbered(f.shape))
    u = torch.full((2, 5000), -1, dtype=torch.int32, device=dev)
    u[:, ::3] = 5
    compare("uint32 max", u.view(torch.uint32), numbered(u.shape))
    if stable:
        radix_edges(torch, dev, gen, compare, numbered, chk)
    else:
        bitonic_edges(torch, dev, gen, compare, numbered)

    def path_rows(seg_len):
        """Keys of valid records with sentinel padding, as the paths give
        them: the stage-2 segments and the wordcount's receive rows."""
        keys = torch.randint(0, (1 << 31) - 1, (WORLD, seg_len),
                             generator=gen, device=dev, dtype=torch.int32)
        keys[:, seg_len - seg_len // 9:] = 0x7FFFFFFF
        vals = torch.arange(seg_len, dtype=torch.int32,
                            device=dev).expand(WORLD, -1).contiguous()
        return keys, vals

    for seg_len in seg_lens:
        keys, vals = path_rows(seg_len)
        compare(f"path rows {(WORLD, seg_len)}", keys, vals)
        del keys, vals
        if not stable:
            keys, vals = stage2_rows(torch, gen, dev, seg_len, stage2_real)
            compare(f"stage-2 input {(WORLD, seg_len)}", keys, vals)
            del keys, vals
    torch.cuda.synchronize()

    def timed(keys, vals):
        return sort_timing(torch, fn, plain, keys, vals,
                           K2_BYTES_PER_KV if stable else 0)

    if stable:
        keys, vals = path_rows(time_len)
        timing = {"data": "random int32 keys, the last ninth of each row "
                          "the int32 maximum", **timed(keys, vals),
                  **radix_launches(torch, keys, vals)}
        del keys, vals
        timing["other_shapes"] = [
            {"data": "random int32 keys, the same kind",
             **timed(*path_rows(n))} for n in seg_lens if n != time_len]
        return chk, timing
    keys = torch.randint(0, (1 << 31) - 1, (WORLD, time_len), generator=gen,
                         device=dev, dtype=torch.int32)
    vals = torch.arange(time_len, dtype=torch.int32,
                        device=dev).expand(WORLD, -1).contiguous()
    timing = {"data": "random int32 keys", **timed(keys, vals),
              **bitonic_launches(torch, keys, vals)}
    del keys, vals
    timing["on_path_rows"] = []
    for seg_len in seg_lens:
        keys, vals = stage2_rows(torch, gen, dev, seg_len, stage2_real)
        timing["on_path_rows"].append(
            {"data": f"stage-2 input: {stage2_real} real keys a row, then "
                     f"the int32 maximum", **timed(keys, vals)})
        del keys, vals
    return chk, timing


def sort_timing(torch, fn, plain, keys, vals, design_bytes: int = 0):
    """Kernel, plain version and ``torch.sort(stable=True)`` + ``gather``
    on one (keys, values) input, beside the 16 B/element bound (keys and
    values read once, written once) and, given ``design_bytes`` per
    element, the time the design's own traffic would take at the same
    rate (K2: 68 B, one read of the keys for the histogram, then every
    pass reads and writes both), computed like the bound, not measured."""
    def library():
        s = torch.sort(keys, dim=-1, stable=True)
        return s.values, torch.gather(vals, -1, s.indices)

    out = {"shape": list(keys.shape),
           "ms": time_ms(torch, lambda: fn(keys, vals)),
           "plain_ms": time_ms(torch, lambda: plain(keys, vals)),
           "library_ms": time_ms(torch, library),
           "library_call": "torch.sort(stable=True) + torch.gather",
           "bound_ms": bound_ms(16 * keys.numel())}
    if design_bytes:
        out["design_traffic_ms"] = bound_ms(design_bytes * keys.numel())
    return out


def radix_edges(torch, dev, gen, compare, numbered, chk):
    """K2 at its design's edges: rows one short of, at and one past its
    tile T, and of 2 T + 1 and 9 T + 5 (the look-back walks over earlier
    tiles); all-equal, all the dtype maximum, sorted and reversed rows; a
    wordcount-like row (three quarters the int32 maximum, the rest Zipf
    word ids below 2^20); 65535 rows of 3; and one 2^24-element row sorted
    three times, bit-identical each time (a race in the look-back would
    show as a difference)."""
    import numpy as np
    from repro_torch.kernels import ref
    from repro_torch.kernels.radix_sort import (MAX_ROWS, TILE,
                                                sort_kv_segments_radix)
    tops = {torch.int32: 0x7FFFFFFF, torch.uint32: -1,
            torch.float32: float("inf")}
    for dtype in (torch.int32, torch.uint32, torch.float32):
        for s in (TILE - 1, TILE, TILE + 1, 2 * TILE + 1, 9 * TILE + 5):
            shape = (3, s)
            keys = make_keys(torch, gen, shape, dtype, dev)
            bits = keys.view(torch.int32)
            bits[:, ::5] = bits[:, :1].clone()     # duplicate runs
            compare(f"{dtype} tile edge {shape}", keys, numbered(shape))
        shape = (2, 9 * TILE + 5)
        keys = make_keys(torch, gen, shape, dtype, dev)
        up = ref.sort_segments_ref(keys).view(torch.int32)
        cases = {
            "all equal": keys.view(torch.int32)[:, :1].expand(shape)
            .contiguous(),
            "all maximum": torch.full(
                shape, tops[dtype], device=dev,
                dtype=torch.float32 if dtype == torch.float32
                else torch.int32).view(torch.int32),
            "sorted": up,
            "reversed": up.flip(-1).contiguous()}
        for what, k in cases.items():
            compare(f"{dtype} {what} {shape}", k.view(dtype), numbered(shape))
    rng = np.random.default_rng(5)
    s = 40 * TILE + 17
    words = ((rng.zipf(ZIPF_A, size=(4, s)) - 1) % VOCAB).astype(np.int32)
    keys = torch.from_numpy(words).to(dev)
    run = s // 32
    for r in range(32):                  # 8 source ranks of 4 slots each
        keys[:, r * run + run // 4:(r + 1) * run] = 0x7FFFFFFF
    compare(f"wordcount-like rows {tuple(keys.shape)}", keys,
            numbered(keys.shape))
    keys = make_keys(torch, gen, (MAX_ROWS, 3), torch.int32, dev)
    compare(f"{MAX_ROWS} rows of 3", keys, numbered(keys.shape))
    s = 1 << 24
    keys = torch.randint(0, 1 << 12, (1, s), generator=gen, device=dev,
                         dtype=torch.int32)
    vals = numbered((1, s))
    first = sort_kv_segments_radix(keys, vals)
    for rep in (2, 3):
        again = sort_kv_segments_radix(keys, vals)
        chk.equal(f"2^24 row, run {rep} key bits", again[0], first[0])
        chk.equal(f"2^24 row, run {rep} values", again[1], first[1])
    compare("2^24 row", keys, vals)


def device_events(torch, call, expected, sessions: int = 5):
    """The device events (kernels, memsets, copies) one ``call()`` makes,
    as (name, ms) from ``torch.profiler``, the names of the CUDA runtime
    calls it made on the host, and the profiler sessions it took. A session
    can lose device events (on the H100 most often its first one: 1 or 2
    of K2's 5 launches were seen in 2 of 17 processes, K1's memset or
    K3's first launch in 5 sessions of 5 at some shapes), so each session
    starts with a fill of its own and counts only what follows the call's
    start. A session never adds an event, so one for which
    ``expected(device names, runtime names)`` fails is followed by
    another, up to ``sessions``; the caller holds the last one to its
    plan."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    warm = torch.empty(1, dtype=torch.int8, device="cuda")
    for n in range(1, sessions + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the session's first device event is the one most often lost
            # (K3's first launch, K1's memset): let it be this fill's
            warm.fill_(1)
            torch.cuda.synchronize()
            with record_function("held_call"):
                out = call()
            torch.cuda.synchronize()
        del out
        start = min(e.time_range.start for e in prof.events()
                    if e.name == "held_call")
        mine = [e for e in prof.events()
                if e.time_range.start >= start and e.name != "held_call"]
        events = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
                  for e in mine if e.device_type == DeviceType.CUDA]
        runtime = [e.name for e in mine if e.device_type == DeviceType.CPU
                   and e.name.startswith("cuda")]
        if expected([name for name, _ in events], runtime):
            break
    return events, runtime, n


def held_to_plan(torch, call, plan, tag: str, what: str,
                 reps: int = TIMED_ITERS):
    """CUDA launches and memsets one ``call()`` makes, counted by
    ``torch.profiler`` and held to ``plan``: the device's kernel events
    whose name holds ``tag``, and the ``cudaMemsetAsync`` calls the host
    made (the device's memset events, which a session can lose, may not
    outnumber them); no other device event may come from the call. Then
    the device time of a call's own kernels and memsets from the
    profiler: their summed durations over ``reps`` calls in one session,
    over ``reps``, a lost memset counted at the mean of the seen ones (set
    beside the CUDA-event window of ``time_ms``, it shows the host time
    inside that window)."""
    def split(names):
        kernels = [n for n in names if tag in n]
        memsets = [n for n in names if n.startswith("Memset")]
        return kernels, memsets, [n for n in names
                                  if n not in kernels and n not in memsets]

    def as_planned(names, runtime, calls=1):
        kernels, memsets, other = split(names)
        return (len(kernels) == calls * plan.cuda_launches
                and runtime.count("cudaMemsetAsync") == calls * plan.memsets
                and len(memsets) <= calls * plan.memsets and not other)

    events, runtime, sessions = device_events(torch, call, as_planned)
    names = [n for n, _ in events]
    kernels, memsets, other = split(names)
    if not as_planned(names, runtime):
        raise AssertionError(
            f"one {what} call made {len(kernels)} CUDA launches and "
            f"{runtime.count('cudaMemsetAsync')} memsets "
            f"({len(memsets)} seen on the device), its plan says "
            f"{plan.cuda_launches} and {plan.memsets}; other device events: "
            f"{other}")

    def repeated():
        for _ in range(reps):
            call()

    timed, timed_runtime, timed_sessions = device_events(
        torch, repeated, lambda n, r: as_planned(n, r, reps))
    kernel_ms = sum(ms for n, ms in timed if tag in n) / reps
    seen = [ms for n, ms in timed if n.startswith("Memset")]
    memset_ms = (statistics.mean(seen) * plan.memsets if seen else 0.0)
    return {"cuda_launches_per_call": len(kernels),
            "memsets_per_call": runtime.count("cudaMemsetAsync"),
            "device_memsets_seen": len(memsets),
            "launch_names": sorted(set(n.split("(")[0] for n in kernels)),
            "profiler_sessions": sessions,
            "profiler_kernel_ms": kernel_ms, "profiler_memset_ms": memset_ms,
            "profiler_ms": kernel_ms + memset_ms,
            "profiler_memsets_seen": f"{len(seen)} of {reps * plan.memsets}",
            "profiler_timed_sessions": timed_sessions,
            "profiler_timed_as_planned": as_planned(
                [n for n, _ in timed], timed_runtime, reps)}


def radix_launches(torch, keys, vals):
    """CUDA launches and memsets one K2 call makes, held to
    ``radix_plan``; no other device event may come from the call."""
    from repro_torch.kernels.radix_sort import (radix_plan,
                                                sort_kv_segments_radix)
    plan = radix_plan(*keys.shape, kv=True)
    out = held_to_plan(torch, lambda: sort_kv_segments_radix(keys, vals),
                       plan, "k2::", "K2")
    return {"tile": plan.tile, **out, "scratch_bytes": plan.scratch_bytes}


def bitonic_edges(torch, dev, gen, compare, numbered):
    """K3 at its design's edges: rows one short of, at and one past the
    block-sort tile T, with 2, 3 and 4 merge passes (the result comes from
    either scratch buffer), all-equal, all-maximum (the padding sentinel),
    sorted and reversed rows, and 65535 rows of 3."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitonic_sort import MAX_ROWS, TILE
    tops = {torch.int32: 0x7FFFFFFF, torch.uint32: -1,
            torch.float32: float("inf")}
    for dtype in (torch.int32, torch.uint32, torch.float32):
        for s in (TILE - 1, TILE, TILE + 1, 2 * TILE + 1, 4 * TILE + 1,
                  9 * TILE + 5):
            shape = (3, s)
            keys = make_keys(torch, gen, shape, dtype, dev)
            bits = keys.view(torch.int32)          # uint32 has few ops
            bits[:, ::5] = bits[:, :1].clone()     # duplicate runs
            compare(f"{dtype} tile edge {shape}", keys, numbered(shape))
        for s in (2 * TILE + 1, 4 * TILE + 1):
            shape = (2, s)
            keys = make_keys(torch, gen, shape, dtype, dev)
            bits = keys.view(torch.int32)
            up = ref.sort_segments_ref(keys).view(torch.int32)
            cases = {
                "all equal": bits[:, :1].expand(shape).contiguous(),
                "all maximum": torch.full(
                    shape, tops[dtype], device=dev,
                    dtype=torch.float32 if dtype == torch.float32
                    else torch.int32).view(torch.int32),
                "sorted": up,
                "reversed": up.flip(-1).contiguous()}
            for what, k in cases.items():
                compare(f"{dtype} {what} {shape}", k.view(dtype),
                        numbered(shape))
    keys = make_keys(torch, gen, (MAX_ROWS, 3), torch.int32, dev)
    compare(f"{MAX_ROWS} rows of 3", keys, numbered(keys.shape))


def stage2_rows(torch, gen, dev, seg_len: int, real: int):
    """The main path's stage-2 sort input (``dataflow.py``, the regroup's
    ``seg_keys``): each rank's ``real`` received keys, all inside its
    bucket's range of the default splitters, in the prefix of the row, the
    rest the int32 maximum; payload = slot index."""
    span = (1 << 31) // WORLD
    keys = torch.randint(0, span, (WORLD, seg_len), generator=gen, device=dev,
                         dtype=torch.int32)
    keys += torch.arange(WORLD, device=dev, dtype=torch.int32)[:, None] * span
    keys[:, real:] = 0x7FFFFFFF
    vals = torch.arange(seg_len, dtype=torch.int32,
                        device=dev).expand(WORLD, -1).contiguous()
    return keys, vals


def bitonic_launches(torch, keys, vals):
    """CUDA launches one K3 call makes, counted by ``torch.profiler`` from
    the device's kernel events and held to the wrapper's pass plan, and
    the call's device memory beyond its inputs."""
    from repro_torch.kernels.bitonic_sort import (pass_plan,
                                                  sort_kv_segments_bitonic)
    plan = pass_plan(*keys.shape)

    def k3(events):
        return [n for n in events if "k3::" in n]

    events, _, sessions = device_events(
        torch, lambda: sort_kv_segments_bitonic(keys, vals),
        lambda ev, _: len(k3(ev)) == plan.cuda_launches)
    names = k3([n for n, _ in events])
    if len(names) != plan.cuda_launches:
        raise AssertionError(f"one K3 call made {len(names)} CUDA launches, "
                             f"its plan says {plan.cuda_launches}: {names}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = sort_kv_segments_bitonic(keys, vals)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    del out
    return {"merge_passes": plan.merge_passes, "tile": plan.tile,
            "cuda_launches_per_call": len(names),
            "launch_names": sorted(set(n.split("(")[0] for n in names)),
            "profiler_sessions": sessions, "call_device_bytes": extra}


# -- phases 4 to 8 ---------------------------------------------------------------


def kernels():
    from repro_torch.kernels import bitonic_sort, bucket_hist, partition, \
        radix_sort
    return (partition.KERNEL, bitonic_sort.KERNEL, radix_sort.KERNEL,
            bucket_hist.KERNEL)


def reset_launches() -> None:
    for k in kernels():
        k.launches = 0


def read_launches() -> dict:
    return {k.name: k.launches for k in kernels()}


def make_records(torch, dev, gen, n: int):
    """N 100-byte records; the first 4 value bytes carry the input index."""
    n_local = n // WORLD
    keys = torch.randint(0, (1 << 31) - 1, (WORLD, n_local), generator=gen,
                         device=dev, dtype=torch.int32)
    value = torch.randint(0, 256, (WORLD, n_local, VALUE_BYTES),
                          generator=gen, device=dev, dtype=torch.uint8)
    index = torch.arange(n, dtype=torch.int32, device=dev)
    value[..., :4] = index.view(torch.uint8).reshape(WORLD, n_local, 4)
    return keys, value


def entry_point_k4(torch, dev, keys):
    """K4's path: ``kernels.ops.bucket_histogram`` on the main path's
    stage-1 bucket ids (the range partition against the default
    splitters)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.sphere.dataflow import default_splitters
    spl = torch.from_numpy(default_splitters(WORLD)).to(dev)
    bucket = torch.searchsorted(spl, keys, right=True, out_int32=True)
    reset_launches()
    counts = kops.bucket_histogram(bucket, WORLD)
    torch.cuda.synchronize()
    launches = read_launches()
    offs = torch.arange(WORLD, device=dev, dtype=torch.int64)[:, None] * WORLD
    want = torch.bincount((bucket + offs).reshape(-1),
                          minlength=WORLD * WORLD).reshape(WORLD, WORLD)
    if not torch.equal(counts.to(torch.int64), want):
        raise AssertionError("bucket_histogram of the stage-1 ids differs "
                             "from torch.bincount")
    if int(counts.sum()) != keys.numel() or launches["bucket_hist"] != 1:
        raise AssertionError(f"K4 entry point: {int(counts.sum())} ids "
                             f"counted, launches {launches}")
    return {"phase": "bucket_histogram_entry_point",
            "shape": list(bucket.shape), "num_buckets": WORLD,
            "per_bucket": counts.sum(dim=0).tolist(), "launches": launches}


def check_sorted_permutation(torch, res, keys, value, what: str):
    """The checks of a 100-byte sort: no drops, every record once, globally
    sorted, each value row beside its key. Returns the sorted keys."""
    from repro_torch.core.sort import SortResult, is_globally_sorted
    n = keys.numel()
    valid = res.valid
    out_k = res.records["key"][valid]
    out_v = res.records["value"][valid]
    dropped = int(res.dropped)
    if dropped != 0:
        raise AssertionError(f"{what} dropped {dropped} records")
    if out_k.numel() != n:
        raise AssertionError(f"{what}: {out_k.numel()} valid records, "
                             f"expected {n}")
    if not is_globally_sorted(SortResult(res.records["key"], None, valid,
                                         res.dropped), WORLD):
        raise AssertionError(f"{what} output is not globally sorted")
    idx = out_v[:, :4].contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    if not torch.equal(torch.sort(idx).values,
                       torch.arange(n, device=keys.device, dtype=torch.int64)):
        raise AssertionError(f"{what}: delivered records are not a "
                             f"permutation")
    if not torch.equal(keys.reshape(-1)[idx], out_k):
        raise AssertionError(f"{what}: a delivered key does not match its "
                             f"record")
    if not torch.equal(value.reshape(n, VALUE_BYTES)[idx], out_v):
        raise AssertionError(f"{what}: a delivered value row does not match "
                             f"its key")
    return out_k


def run_path(torch, ex, df, records):
    """One cold run of ``df``: launch counts read from zero, host wall
    time ending in a synchronize, peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    a2a = ex.ranks.collectives["all_to_all"]
    t0 = time.perf_counter()
    res = ex.run(df, records)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, {"wall_ms": wall * 1e3, "launches": read_launches(),
                 "all_to_all": ex.ranks.collectives["all_to_all"] - a2a,
                 "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def main_path(torch, keys, value, profile_dir=None):
    from repro_torch.comm import Ranks
    from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

    n = keys.numel()
    df = Dataflow.source().sort(key=lambda r: r["key"], num_buckets=WORLD,
                                capacity_factor=2.0)
    ex = SPMDExecutor(Ranks(WORLD), sort_algo="bitonic")
    res, run = run_path(torch, ex, df, {"key": keys, "value": value})
    sorted_keys = check_sorted_permutation(torch, res, keys, value,
                                           "main path").clone()
    for name in ("partition", "bitonic_sort"):
        if run["launches"][name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    out = {"phase": "main_path", "records": n, "record_bytes": 4 + VALUE_BYTES,
           "ranks": WORLD, "sort_algo": "bitonic",
           "records_per_s": n / run["wall_ms"] * 1e3, **run,
           "dropped": int(res.dropped), "cache": ex.cache_info()._asdict()}
    del res
    if profile_dir:
        out["profile"] = profile_run(
            torch, lambda: ex.run(df, {"key": keys, "value": value}),
            profile_dir, "main_path")
    torch.cuda.empty_cache()
    return out, sorted_keys


def grid_path(torch, keys, value, flat_sorted_keys, profile_dir=None):
    """The wide-area path: the main path's pipeline and records on the
    ``(dc, node)`` grid, so each shuffle is the two-level exchange."""
    from repro_torch.comm import Ranks
    from repro_torch.core.shuffle import ShufflePlan
    from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

    n = keys.numel()
    grid = Ranks(shape=GRID, axes=("dc", "node"))
    df = Dataflow.source().sort(key=lambda r: r["key"], num_buckets=WORLD,
                                capacity_factor=2.0)
    ex = SPMDExecutor(grid, sort_algo="bitonic")
    res, run = run_path(torch, ex, df, {"key": keys, "value": value})
    out_k = check_sorted_permutation(torch, res, keys, value,
                                     "wide-area path")
    if not torch.equal(out_k, flat_sorted_keys):
        raise AssertionError("wide-area sorted keys differ from the flat "
                             "path's")
    want = {"partition": 3, "bitonic_sort": 1}
    got = {k: run["launches"][k] for k in want}
    if got != want or run["all_to_all"] != 2:
        raise AssertionError(f"wide-area path launched {run['launches']} "
                             f"with {run['all_to_all']} all_to_all; expected "
                             f"{want} and 2")
    del res, out_k
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = ex.run(df, {"key": keys, "value": value})
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    del warm
    n_local = n // WORLD
    hier = ShufflePlan.for_ranks(grid, WORLD, n_local, 2.0)
    flat = ShufflePlan.for_ranks(Ranks(WORLD), WORLD, n_local, 2.0)
    wan = {name: {meta: plan.wan_profile(*GRID, 4 + VALUE_BYTES,
                                         wire_meta=meta)
                  for meta in ("full", "min")}
           for name, plan in (("hierarchical", hier), ("flat", flat))}
    if (wan["hierarchical"]["min"]["wan_tiles"] != GRID[0] - 1
            or wan["flat"]["min"]["wan_tiles"] != (GRID[0] - 1) * GRID[1]):
        raise AssertionError(f"WAN tiles per rank: {wan}")
    out = {"phase": "wide_area_path", "records": n, "grid": list(GRID),
           "axes": ["dc", "node"], "sort_algo": "bitonic",
           "records_per_s": n / run["wall_ms"] * 1e3, **run,
           "warm_wall_ms": warm_ms, "warm_records_per_s": n / warm_ms * 1e3,
           "same_keys_as_flat": True, "cache": ex.cache_info()._asdict(),
           "plans": {"hierarchical": [hier.axes, hier.capacities],
                     "flat": [flat.axes, flat.capacities]},
           "wan_profile": wan}
    if profile_dir:
        out["profile"] = profile_run(
            torch, lambda: ex.run(df, {"key": keys, "value": value}),
            profile_dir, "wide_area_path")
    torch.cuda.empty_cache()
    return out


def wordcount_path(torch, dev, seed: int, sh: Shapes, profile_dir=None):
    """MapReduce wordcount over 8 ranks, the reduce's sort pinned to K2."""
    import numpy as np
    from repro_torch.comm import Ranks
    from repro_torch.core.mapreduce import default_hash, reduce_by_key_sum
    from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

    n_words = sh.words
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    words = ((rng.zipf(ZIPF_A, size=n_words) - 1) % VOCAB).astype(np.int32)
    gen_s = time.perf_counter() - t0
    word_t = torch.from_numpy(words).reshape(WORLD, -1).to(dev)

    def count(rec, valid):
        k, s, d = reduce_by_key_sum(rec["key"], rec["value"], valid,
                                    algo="radix")
        return {"key": k, "value": s}, k >= 0, d

    shuffled = (Dataflow.source()
                .map(lambda r: {"key": r["word"],
                                "value": torch.ones_like(r["word"])})
                .shuffle(by=lambda r: default_hash(r["key"], WORLD),
                         num_buckets=WORLD))
    df = shuffled.reduce(count)
    ex = SPMDExecutor(Ranks(WORLD))
    res, run = run_path(torch, ex, df, {"word": word_t})
    if run["launches"]["radix_sort"] == 0 or run["launches"]["partition"] == 0:
        raise AssertionError(f"wordcount launched {run['launches']}")
    dropped = int(res.dropped)
    keys = res.records["key"][res.valid].cpu().numpy()
    counts = res.records["value"][res.valid].cpu().numpy()
    want = np.bincount(words, minlength=VOCAB)
    if dropped != 0:
        raise AssertionError(f"wordcount dropped {dropped}")
    if np.unique(keys).size != keys.size:
        raise AssertionError("a word was reduced on two ranks")
    got = np.zeros(VOCAB, np.int64)
    got[keys] = counts
    if not np.array_equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"wordcount differs from np.bincount on {bad} "
                             f"words")
    if keys.size != int((want > 0).sum()):
        raise AssertionError("wrong number of distinct words")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = ex.run(df, {"word": word_t})
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    del warm, res
    out = {"phase": "wordcount", "words": n_words, "vocab": VOCAB,
           "zipf": ZIPF_A, "ranks": WORLD, "reduce_sort": "radix",
           "distinct_words": int(keys.size), "top_word_share":
           float(want.max() / n_words), "dropped": dropped,
           "words_per_s": n_words / run["wall_ms"] * 1e3, **run,
           "warm_wall_ms": warm_ms, "warm_words_per_s": n_words / warm_ms
           * 1e3, "numpy_words_s": gen_s, "recv_rows_per_rank": sh.wc_recv}
    out["k2_on_path_rows"] = radix_on_reduce_input(torch, ex, shuffled,
                                                   word_t)
    if profile_dir:
        out["profile"] = profile_run(
            torch, lambda: ex.run(df, {"word": word_t}), profile_dir,
            "wordcount")
    torch.cuda.empty_cache()
    return out


def radix_on_reduce_input(torch, ex, shuffled, word_t):
    """K2 against its plain version, tolerance 0, on the wordcount's own
    sort input: every rank's received keys with the int32 maximum in the
    empty slots, as ``reduce_by_key_sum`` hands them to the sort. Word ids
    below 2^20 and mostly-empty rows make its scatters far more regular
    than the random keys of phase 3."""
    from repro_torch.kernels.radix_sort import (sort_kv_segments_radix,
                                                sort_kv_segments_radix_ref)
    res = ex.run(shuffled, {"word": word_t})
    keys = torch.where(res.valid, res.records["key"], 0x7FFFFFFF).contiguous()
    del res
    vals = torch.arange(keys.shape[1], dtype=torch.int32,
                        device=keys.device).expand(WORLD, -1).contiguous()
    chk = Check("radix_sort")
    gk, gv = sort_kv_segments_radix(keys, vals)
    rk, rv = sort_kv_segments_radix_ref(keys, vals)
    chk.equal("keys on the reduce input", gk, rk)
    chk.equal("values on the reduce input", gv, rv)
    del gk, gv, rk, rv

    return {"data": "the wordcount's own sort input", "cases": chk.cases,
            "max_abs_err": chk.max_abs_err,
            "valid_share": float((keys != 0x7FFFFFFF).float().mean()),
            **sort_timing(torch, sort_kv_segments_radix,
                          sort_kv_segments_radix_ref, keys, vals,
                          K2_BYTES_PER_KV)}


def host_input(torch, keys, value):
    """Phase 5's input records, packed into 100-byte rows on the card and
    copied to the host once: ``WORLD`` numpy slices, the Sector files of
    phase 9."""
    import numpy as np
    from repro_torch.core.records import RecordCodec
    codec = RecordCodec.from_fields({"key": "int32",
                                     "value": ("uint8", (VALUE_BYTES,))})
    rows = codec.pack({"key": keys.reshape(-1),
                       "value": value.reshape(-1, VALUE_BYTES)})
    block = rows.cpu().numpy()
    del rows
    return codec, np.array_split(block, WORLD)


def filesystem_of(path: str) -> str:
    """'<mount point> <type>' of the file system holding ``path``."""
    best = ("?", "?")
    real = os.path.realpath(path)
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best[0].rstrip("?")):
                best = (mnt, parts[2])
    return " ".join(best)


class SectorDeployment:
    """``make_sector`` over ``WORLD`` slaves in a temporary directory on the
    machine's local disk (removed by :meth:`close`), replication 2, the
    input uploaded as ``WORLD`` slices and replicated, one SPE per slave."""

    def __init__(self, slices, tag: str):
        import shutil
        import tempfile
        from repro_torch.launch.train import make_sector
        self.root = tempfile.mkdtemp(prefix=f"chip_smoke_sector_{tag}_")
        self.free_bytes = shutil.disk_usage(self.root).free
        self.fs = filesystem_of(self.root)
        # input and one run's bucket files, each twice (replication 2)
        need = 4 * sum(s.nbytes for s in slices)
        if self.free_bytes < need + (1 << 30):
            self.close()
            raise RuntimeError(f"{self.root} ({self.fs}) has "
                               f"{self.free_bytes} bytes free; the host "
                               f"path needs {need} and 1 GiB to spare")
        try:
            self.master, self.client, self.daemon = make_sector(
                self.root, num_slaves=WORLD, replication=2)
            t0 = time.perf_counter()
            self.client.upload_dataset("/terasort/in",
                                       [s.tobytes() for s in slices])
            self.daemon.run_until_stable()
            self.setup_s = time.perf_counter() - t0
        except BaseException:
            self.close()
            raise
        self.paths = [f"/terasort/in.{i:05d}" for i in range(len(slices))]

    def spes(self, fail_after=None):
        from repro_torch.sphere.spe import SPE
        return [SPE(i, self.master.slaves[i].address, self.master,
                    self.client.session_id,
                    fail_after=(fail_after or {}).get(i))
                for i in range(WORLD)]

    def host_rates(self, block) -> dict:
        """GB/s of the host work each bucket byte meets on this machine,
        on one slice: ``tobytes``, md5 (every slave write hashes), a file
        write and a read back on the deployment's file system."""
        import hashlib
        path = os.path.join(self.root, "rate_probe")
        t0 = time.perf_counter()
        data = block.tobytes()
        t1 = time.perf_counter()
        hashlib.md5(data).hexdigest()
        t2 = time.perf_counter()
        with open(path, "wb") as f:
            f.write(data)
        t3 = time.perf_counter()
        with open(path, "rb") as f:
            f.read()
        t4 = time.perf_counter()
        os.remove(path)
        gb = len(data) / 1e9
        return {"bytes": len(data), "tobytes_gb_s": gb / (t1 - t0),
                "md5_gb_s": gb / (t2 - t1), "write_gb_s": gb / (t3 - t2),
                "read_gb_s": gb / (t4 - t3)}

    def disk_bytes(self) -> int:
        return sum(s.used_bytes() for s in self.master.slaves.values())

    def drop_scratch(self) -> None:
        """Delete every bucket file of earlier runs (disk space)."""
        for meta in self.client.ls("/.dataflow"):
            self.client.delete(meta.path)

    def close(self) -> None:
        import shutil
        shutil.rmtree(self.root, ignore_errors=True)


class TimedDaemon:
    """The executor's replication daemon, timed: ``seconds`` of
    ``run_until_stable`` (the replication half of ``materialize_s``)."""

    def __init__(self, daemon):
        self.daemon = daemon
        self.seconds = 0.0

    def run_until_stable(self):
        t0 = time.perf_counter()
        made = self.daemon.run_until_stable()
        self.seconds += time.perf_counter() - t0
        return made


class SlaveClock:
    """While entered, the seconds and calls of every slave's
    ``write_file`` and, inside it, of its md5, and of ``used_bytes`` (a
    walk of the slave's directory, by every write and by the master's
    placement): the host work each Sector write costs, measured on the
    path."""

    NAMES = ("write_file", "md5", "used_bytes")

    def __init__(self):
        self.seconds = dict.fromkeys(self.NAMES, 0.0)
        self.calls = dict.fromkeys(self.NAMES, 0)

    def _timed(self, name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
        return timed

    def __enter__(self):
        from repro_torch.sector import slave
        self._saved = [(slave, "_md5", slave._md5),
                       (slave.SlaveNode, "used_bytes",
                        slave.SlaveNode.used_bytes),
                       (slave.SlaveNode, "write_file",
                        slave.SlaveNode.write_file)]
        for owner, attr, fn in self._saved:
            setattr(owner, attr, self._timed(attr.lstrip("_"), fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)

    def report(self) -> dict:
        return {"seconds": dict(self.seconds), "calls": dict(self.calls)}


def span_seconds(tracer) -> dict:
    """Seconds of the host run's spans by phase: the SPEs' reads (download,
    copy to the card, unpack) and UDFs (the phase's device work, ending
    in the copy of the bucket rows to the host in phase 0; phase 1's
    output stays on the card unsynchronised), and the bucket files'
    upload and replication."""
    spans = tracer.buffer.spans()
    by_id = {sp.span_id: sp for sp in spans}
    out = {}
    for sp in spans:
        if sp.duration is None:
            continue
        cur = sp
        while cur is not None and not cur.name.startswith("phase["):
            cur = by_id.get(cur.parent_id)
        if cur is None:
            continue
        name = ("hop_buckets" if sp.name.startswith("hop[") else
                "segments" if sp.name.startswith("segment[") else sp.name)
        if name in ("spe.read", "spe.udf", "segments", "hop_buckets"):
            row = out.setdefault(cur.name, {})
            row[name] = row.get(name, 0.0) + sp.duration
    return out


def host_path(torch, dev, codec, slices, flat_sorted_keys, checks,
              profile_dir=None):
    """Phase 9: Terasort over Sector files through ``HostExecutor`` — the
    paper's own data plane. Phase 0 decodes each input slice on the card
    and splits it into bucket files with K1; phase 1 sorts each bucket
    file with K2. Checks, cold and warm wall, the per-phase split, disk
    bytes, peak memory; then K1 and K2 against their plain versions at
    the shapes this path gave them; then a small run with a crashing
    SPE."""
    import numpy as np
    from repro_torch.kernels import partition, radix_sort, ref
    from repro_torch.obs.trace import Tracer
    from repro_torch.sphere.dataflow import Dataflow, HostExecutor

    n = sum(s.shape[0] for s in slices)
    df = Dataflow.source(codec).sort(key=lambda r: r["key"],
                                     num_buckets=WORLD)
    rows = torch.from_numpy(np.concatenate(slices)).to(dev)
    inp = codec.unpack(rows)
    in_keys = inp["key"].clone()
    in_value = inp["value"]
    want_keys = torch.sort(in_keys).values
    del rows, inp
    if not torch.equal(want_keys, flat_sorted_keys.to(dev)):
        raise AssertionError("torch.sort of the host input differs from "
                             "phase 5's sorted keys")
    sector = SectorDeployment(slices, "big")
    try:
        daemon = TimedDaemon(sector.daemon)
        disk0 = sector.disk_bytes()
        ex = HostExecutor(sector.master, sector.client, sector.spes(),
                          daemon=daemon)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = ex.run(df, sector.paths)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        disk_written = sector.disk_bytes() - disk0
        segs = [p["segments"] for p in res.phase_times]
        check_host_result(torch, res, in_keys, in_value, want_keys,
                          "host path")
        want = {"partition": segs[0], "radix_sort": segs[1]}
        got = {k: launches[k] for k in want}
        if got != want or launches["bitonic_sort"] or launches["bucket_hist"]:
            raise AssertionError(f"host path launched {launches}; expected "
                                 f"K1 once per phase-0 segment and K2 once "
                                 f"per phase-1 bucket file: {want}")
        phases = [{k: p[k] for k in ("phase", "terminator", "seconds",
                                     "engine_s", "materialize_s",
                                     "segments")} for p in res.phase_times]
        cold_replication_s = daemon.seconds
        del res
        sector.drop_scratch()
        tracer = Tracer()
        daemon.seconds = 0.0
        torch.cuda.synchronize()
        with SlaveClock() as slave_clock:
            t0 = time.perf_counter()
            warm = ex.run(df, sector.paths, trace=tracer)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        warm_phases = [{k: p[k] for k in ("seconds", "engine_s",
                                          "materialize_s")}
                       for p in warm.phase_times]
        check_host_result(torch, warm, in_keys, in_value, want_keys,
                          "host path, warm")
        del warm
        out = {"phase": "host_sector_terasort", "records": n,
               "record_bytes": codec.nbytes, "slaves": WORLD,
               "replication": 2, "spes": WORLD, "buckets": WORLD,
               "segments": segs, "launches": launches,
               "wall_ms": cold * 1e3, "records_per_s": n / cold,
               "warm_wall_ms": warm_s * 1e3, "warm_records_per_s": n / warm_s,
               "phase_times": phases, "warm_phase_times": warm_phases,
               "replication_s": cold_replication_s,
               "warm_replication_s": daemon.seconds,
               "warm_spans_s": span_seconds(tracer),
               "warm_slave_writes": slave_clock.report(),
               "setup_s": sector.setup_s,
               "disk_bytes_written": disk_written,
               "disk_free_bytes_before": sector.free_bytes,
               "disk": f"{sector.root} on {sector.fs}",
               "peak_mem_bytes": peak, "errors": 0, "data_errors": 0,
               "host_rates": sector.host_rates(slices[0]),
               "same_keys_as_flat": True}
        if profile_dir:
            def once():
                sector.drop_scratch()
                return ex.run(df, sector.paths)
            sector.drop_scratch()
            out["profile"] = profile_run(torch, once, profile_dir,
                                         "host_sector_terasort")
    finally:
        sector.close()
    del in_keys, in_value, want_keys
    torch.cuda.empty_cache()

    # K1 and K2 held to their plain versions at this path's shapes
    seg_n = slices[0].shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    ids = torch.randint(0, WORLD, (seg_n,), generator=gen, device=dev,
                        dtype=torch.int32)
    k1 = checks["partition"][0]
    rank, counts = partition.partition_rank(ids, WORLD)
    rrank, rcounts = ref.partition_rank_ref(ids, WORLD)
    k1.equal("host bucket split ranks", rank, rrank)
    k1.equal("host bucket split counts", counts, rcounts)
    keys = torch.randint(0, (1 << 31) - 1, (1, seg_n), generator=gen,
                         device=dev, dtype=torch.int32)
    pos = torch.arange(seg_n, dtype=torch.int32, device=dev)[None]
    k2 = checks["radix_sort"][0]
    gk, gv = radix_sort.sort_kv_segments_radix(keys, pos)
    rk, rv = radix_sort.sort_kv_segments_radix_ref(keys, pos)
    k2.equal("host stage-2 keys", gk, rk)
    k2.equal("host stage-2 order", gv, rv)
    out["kernels_at_path_shapes"] = [
        {"name": "partition", "shape": [1, seg_n], "num_dest": WORLD,
         "ms": time_ms(torch, lambda: partition.partition_rank(ids, WORLD)),
         "plain_ms": time_ms(torch, lambda: ref.partition_rank_ref(
             ids, WORLD), iters=3),
         "library_ms": time_ms(torch, lambda: torch.bincount(
             ids, minlength=WORLD)),
         "bound_ms": bound_ms(8 * seg_n + 4 * WORLD)},
        {"name": "radix_sort", "shape": [1, seg_n],
         "ms": time_ms(torch, lambda: radix_sort.sort_kv_segments_radix(
             keys, pos)),
         "plain_ms": time_ms(torch, lambda: radix_sort.
                             sort_kv_segments_radix_ref(keys, pos), iters=3),
         "library_ms": time_ms(torch, lambda: torch.sort(
             keys, dim=1, stable=True)),
         "bound_ms": bound_ms(16 * seg_n)}]
    del ids, rank, counts, rrank, rcounts, keys, pos, gk, gv, rk, rv
    out["crash_run"] = host_crash_run(torch, dev, codec, slices, df)
    torch.cuda.empty_cache()
    return out


def check_host_result(torch, res, in_keys, in_value, want_keys, what: str):
    """A host sort's output: no errors, every record once, globally sorted,
    each value row beside its key, keys equal to ``torch.sort`` of the
    input's."""
    if res.errors or res.data_errors:
        raise AssertionError(f"{what}: errors {res.errors}, data_errors "
                             f"{res.data_errors}")
    out_k, out_v = res.records["key"], res.records["value"]
    n = in_keys.numel()
    if out_k.numel() != n or not bool(res.valid.all()):
        raise AssertionError(f"{what}: {out_k.numel()} records, expected {n}")
    if not torch.equal(out_k, want_keys):
        raise AssertionError(f"{what}: keys differ from torch.sort of the "
                             f"input keys")
    idx = out_v[:, :4].contiguous().view(torch.int32).reshape(-1).to(
        torch.int64)
    if not torch.equal(torch.sort(idx).values,
                       torch.arange(n, device=idx.device, dtype=torch.int64)):
        raise AssertionError(f"{what}: delivered records are not a "
                             f"permutation")
    if not torch.equal(in_keys[idx], out_k) or not torch.equal(
            in_value[idx], out_v):
        raise AssertionError(f"{what}: a delivered value row does not match "
                             f"its key")


def by_index(torch, res):
    """A sort's records ordered by the input index in their first value
    bytes."""
    idx = res.records["value"][:, :4].contiguous().view(torch.int32)
    order = torch.argsort(idx.reshape(-1))
    return res.records["key"][order], res.records["value"][order]


def host_crash_run(torch, dev, codec, slices, df, n_small: int = 1 << 20):
    """The host sort of a small prefix of the input twice: once as is, then
    with the SPE that did the most segments crashing after its first
    (``fail_after=1``). The same sorted keys and the same records, and
    the retry must show."""
    from repro_torch.sphere.dataflow import HostExecutor
    per = n_small // WORLD
    small = [s[:per] for s in slices]
    n_small = sum(s.shape[0] for s in small)
    sector = SectorDeployment(small, "small")
    try:
        spes = sector.spes()
        base = HostExecutor(sector.master, sector.client, spes,
                            daemon=sector.daemon).run(df, sector.paths)
        busiest = max(spes, key=lambda s: (s.segments_done, -s.spe_id))
        crashing = sector.spes(fail_after={busiest.spe_id: 1})
        res = HostExecutor(sector.master, sector.client, crashing,
                           daemon=sector.daemon).run(df, sector.paths)
        if res.retries < 1 or res.errors or res.data_errors:
            raise AssertionError(f"crash run: retries {res.retries}, errors "
                                 f"{res.errors}")
        # equal keys may come out in another order: a re-pooled segment
        # reaches the bucket files later (arrival order, as in the JAX
        # package), so records are compared by their input index
        if not torch.equal(res.records["key"], base.records["key"]):
            raise AssertionError("crash run: keys differ from the run "
                                 "without the crash")
        for f, (a, b) in zip(("key", "value"), zip(by_index(torch, res),
                                                   by_index(torch, base))):
            if not torch.equal(a, b):
                raise AssertionError(f"crash run: {f} of a record differs "
                                     f"from the run without the crash")
        return {"records": n_small, "crashing_spe": busiest.spe_id,
                "retries": res.retries, "same_output": True}
    finally:
        sector.close()


def profile_run(torch, run_once, out_dir: str, name: str):
    """Two more runs of a path (``run_once()``): one warm (steady-state
    wall time), one under ``torch.profiler``. From the profiled run alone: the time of
    every device-side event (kernels, copies, fills; an operator's own row
    is left out so that no time is counted twice), the union of their
    intervals, and that union's share of the profiled run's wall time.
    Writes the Chrome trace to ``out_dir/<name>_trace.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_once()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device event")
    by_name = {}
    busy_us, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        us, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (us + end - start, calls + 1)
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"warm_wall_ms": warm * 1e3, "profiled_wall_ms": prof_wall * 1e3,
            "device_event_ms": sum(us for us, _ in by_name.values()) / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_span_ms": (spans[-1][1] - spans[0][0]) / 1e3,
            "device_busy_share": busy_us / 1e3 / (prof_wall * 1e3),
            "top": [{"op": k[:90], "ms": us / 1e3, "calls": c}
                    for k, (us, c) in rows[:25]]}


def shim_runs(torch, dev, gen, n_log2: int):
    from repro_torch.comm import Ranks
    from repro_torch.core.sort import (hadoop_style_sort, is_globally_sorted,
                                       terasort)
    from repro_torch.kernels import autotune, radix_sort

    ranks = Ranks(WORLD)
    out = {}

    def run(n, **kw):
        keys = torch.randint(0, (1 << 31) - 1, (WORLD, n // WORLD),
                             generator=gen, device=dev, dtype=torch.int32)
        payload = torch.arange(n, dtype=torch.int32,
                               device=dev).reshape(WORLD, -1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = terasort(keys, payload, ranks, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        vk, vp = res.keys[res.valid], res.payload[res.valid]
        ok = (int(res.dropped) == 0 and vk.numel() == n
              and is_globally_sorted(res, WORLD)
              and torch.equal(keys.reshape(-1)[vp.to(torch.int64)], vk)
              and torch.equal(torch.sort(vp).values, payload.reshape(-1)))
        if not ok:
            raise AssertionError(f"terasort {kw} at N={n}: not a sorted "
                                 f"permutation without drops")
        return keys, payload, res, wall

    n = 1 << n_log2
    radix_sort.KERNEL.launches = 0
    _, _, _, wall = run(n, sort_algo="radix")
    radix_launches = radix_sort.KERNEL.launches
    if radix_launches == 0:
        raise AssertionError("sort_algo='radix' did not launch the radix "
                             "kernel")
    out["radix"] = {"records": n, "wall_ms": wall * 1e3,
                    "launches": radix_launches}
    _, _, _, wall = run(n, buckets_per_device=4)
    out["bpd4"] = {"records": n, "wall_ms": wall * 1e3}

    nh = 1 << min(n_log2, 22)
    keys, payload, a, _ = run(nh)
    hadoop_style_sort(keys, payload, ranks)   # the autotuner measures here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = hadoop_style_sort(keys, payload, ranks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.equal(a.keys[a.valid], b.keys[b.valid]):
        raise AssertionError("hadoop_style_sort keys differ from terasort's")
    out["hadoop"] = {"records": nh, "wall_ms": wall * 1e3}

    seg_cap = WORLD * (int(n // WORLD / WORLD * 2.0) + 1)
    choice = autotune.choose(WORLD, seg_cap, torch.int32, device=dev)
    out["autotune"] = {"cell": autotune.cell_key(WORLD, seg_cap, torch.int32,
                                                 True, "cuda"),
                       "algo": choice.algo, "source": choice.source,
                       "melem": dict(choice.melem),
                       "skipped": dict(choice.skipped)}
    return out, radix_launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-log2", type=int, default=25,
                    help="log2 of the record count of the sort paths (the "
                         "wordcount reads twice as many words)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile two warm reruns of the flat, the "
                         "wide-area and the wordcount path and write their "
                         "traces to DIR")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = build.build_all([k.name for k in kernels()])
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "per_source_s": {k: r.seconds for k, r in built.items()}}))
    for name, r in built.items():
        for line in r.ptxas:
            log(f"  {name}: {line}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    sh = Shapes(args.n_log2)
    checks = {"partition": check_partition(torch, dev, gen, sh),
              "bitonic_sort": check_sort(torch, dev, gen, "bitonic_sort",
                                         [sh.recv, sh.recv_grid], sh.recv,
                                         stage2_real=sh.n_local),
              "radix_sort": check_sort(torch, dev, gen, "radix_sort",
                                       [sh.recv, sh.wc_recv], sh.wc_recv),
              "bucket_hist": check_bucket_hist(torch, dev, gen, sh)}
    for name, (chk, timing) in checks.items():
        log(json.dumps({"phase": "kernel_check", "name": name,
                        "cases": chk.cases, "max_abs_err": chk.max_abs_err,
                        **timing}))
    torch.cuda.empty_cache()

    keys, value = make_records(torch, dev, gen, sh.n)
    k4 = entry_point_k4(torch, dev, keys)
    log(json.dumps(k4))
    mp, flat_sorted = main_path(torch, keys, value, args.profile)
    log(json.dumps(mp))
    wide = grid_path(torch, keys, value, flat_sorted, args.profile)
    log(json.dumps(wide))
    host_codec, host_slices = host_input(torch, keys, value)
    host_flat = flat_sorted.cpu()
    del keys, value, flat_sorted
    torch.cuda.empty_cache()
    wc = wordcount_path(torch, dev, args.seed, sh, args.profile)
    log(json.dumps(wc))
    shim, radix_launches = shim_runs(torch, dev, gen, args.n_log2)
    log(json.dumps({"phase": "terasort_shim", **shim}))
    t0 = time.perf_counter()
    host = host_path(torch, dev, host_codec, host_slices, host_flat, checks,
                     args.profile)
    host["phase_s"] = time.perf_counter() - t0
    log(json.dumps(host))
    del host_slices, host_flat

    paths = {
        "partition": {"dataflow sort, flat": mp["launches"]["partition"],
                      "dataflow sort, (dc, node)":
                          wide["launches"]["partition"],
                      "wordcount": wc["launches"]["partition"],
                      "host terasort over Sector, bucket split":
                          host["launches"]["partition"]},
        "bitonic_sort": {"dataflow sort, flat": mp["launches"]["bitonic_sort"],
                         "dataflow sort, (dc, node)":
                             wide["launches"]["bitonic_sort"]},
        "radix_sort": {"wordcount reduce_by_key_sum(algo='radix')":
                           wc["launches"]["radix_sort"],
                       "terasort sort_algo='radix'": radix_launches,
                       "host terasort over Sector, stage-2 sort":
                           host["launches"]["radix_sort"]},
        "bucket_hist": {"kernels.ops.bucket_histogram (entry point; on no "
                        "dataflow path, as in the JAX package)":
                            k4["launches"]["bucket_hist"]},
    }
    rows = []
    for k in kernels():
        chk, timing = checks[k.name]
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces,
            "launches": sum(paths[k.name].values()),
            "launches_by_path": paths[k.name],
            "path": " + ".join(paths[k.name]),
            "max_abs_err": chk.max_abs_err, "tolerance": 0,
            "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": "bytes", "library_ms": timing["library_ms"],
            "shape": timing["shape"], "check": "ok"})
        if k.name == "radix_sort":
            rows[-1]["cuda_launches_per_call"] = \
                timing["cuda_launches_per_call"]
            rows[-1]["shapes"] = [
                {f: r[f] for f in ("data", "shape", "ms", "plain_ms",
                                   "library_ms", "bound_ms")}
                for r in (timing, wc["k2_on_path_rows"],
                          *timing["other_shapes"])]
        if k.name == "partition":
            rows[-1]["cuda_launches_per_call"] = \
                timing["cuda_launches_per_call"]
            rows[-1]["memsets_per_call"] = timing["memsets_per_call"]
            rows[-1]["shapes"] = [
                {f: r[f] for f in ("path", "shape", "num_dest", "ms",
                                   "profiler_ms", "bound_ms")}
                for r in timing["shapes"]]
        if k.name == "bucket_hist":
            rows[-1]["cuda_launches_per_call"] = \
                timing["cuda_launches_per_call"]
            rows[-1]["memsets_per_call"] = timing["memsets_per_call"]
            rows[-1]["shapes"] = [
                {f: r[f] for f in ("shape", "num_buckets", "ms",
                                   "profiler_ms", "plain_ms", "library_ms",
                                   "bound_ms")}
                for r in (timing, timing["one_row"])]
        if k.name == "bitonic_sort":
            rows[-1]["cuda_launches_per_call"] = \
                timing["cuda_launches_per_call"]
            rows[-1]["on_path_rows"] = [
                {f: r[f] for f in ("shape", "ms", "plain_ms", "library_ms",
                                   "bound_ms")}
                for r in timing["on_path_rows"]]
    log(json.dumps({"kernels": rows}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
