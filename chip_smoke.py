#!/usr/bin/env python3
"""Drive the PyTorch port's Terasort main path on one NVIDIA GPU.

    python3 chip_smoke.py                 # N = 2^25 100-byte records
    python3 chip_smoke.py --n-log2 20     # a quick, smaller run

Phases, in order (any failure ends the script with a non-zero exit):

1. the card's name and power limit (``nvidia-smi``);
2. build the Hopper kernels K1 (partition rank), K3 (bitonic sort) and
   K2 (radix sort) from ``src/repro_torch/kernels/csrc`` with ``nvcc``,
   all at once, printing seconds and the ``-Xptxas -v`` lines;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge cases, and time kernel, plain version
   and the nearest single PyTorch call (CUDA events, median of 10 warm
   runs) beside the memory bound;
4. the main path: ``Dataflow.source().sort(...)`` over 8 stacked ranks of
   100-byte records ``{"key": int32, "value": uint8[96]}``, bitonic
   pinned; checks a globally sorted permutation with every value row
   still beside its key and no drops, and that K1 and K3 ran;
5. the ``terasort()`` shim three ways — ``sort_algo="radix"`` (K2 must
   run), ``buckets_per_device=4``, and ``hadoop_style_sort`` against
   ``terasort`` — and the autotuner's choice for the main-path cell.

The last lines are the kernel table as one JSON object, the
``nvidia-smi`` name/power line, and ``{"ok": true, "device": {...}}``.
Imports nothing of JAX and nothing of the JAX package.
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
VALUE_BYTES = 96             # + the 4-byte key = one 100-byte record
TIMED_ITERS = 10


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
    """Each row's multiset of (key, value) pairs whose key is below the
    dtype maximum, as sorted int64 codes (pairs keyed by the maximum — the
    padding sentinel — may trade payloads with padding in an unstable
    sort; the rows' keys are compared separately)."""
    from repro_torch.kernels.radix_sort import key_to_sortable_bits
    kb = key_to_sortable_bits(keys).view(torch.int32).to(torch.int64)
    kb = kb & 0xFFFFFFFF
    code = (kb << 32) | (vals.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
    # sortable bits of the dtype maximum: int32/uint32 max, float32 +inf
    top = 0xFF800000 if keys.dtype == torch.float32 else 0xFFFFFFFF
    code = torch.where(kb == top, torch.iinfo(torch.int64).max, code)
    return torch.sort(code, dim=-1).values


def make_keys(torch, gen, shape, dtype, dev):
    if dtype == torch.float32:
        return torch.randn(shape, generator=gen, device=dev)
    bits = torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=gen,
                         device=dev, dtype=torch.int32)
    return bits if dtype == torch.int32 else bits.view(torch.uint32)


def check_partition(torch, dev, gen, n_local: int, recv: int):
    from repro_torch.kernels import partition, ref
    chk = Check("partition_rank")
    cases = [((WORLD, n_local), WORLD, WORLD + 1),       # send path (+overflow)
             ((WORLD, recv), 1, 2),                       # regroup, bpd = 1
             ((WORLD, recv), 4, 5),                       # regroup, bpd = 4
             ((3, 5000), 9, 12), ((17, 33), 1, 3), ((1, 4097), 4096, 4096),
             ((2, 1), 8, 9)]
    for shape, nd, hi in cases:
        dest = torch.randint(-2, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
        rank, counts = partition.partition_rank(dest, nd)
        rrank, rcounts = ref.partition_rank_ref(dest, nd)
        chk.equal(f"counts {shape} D={nd}", counts, rcounts)
        chk.equal(f"rank {shape} D={nd}", rank, rrank,
                  mask=(dest >= 0) & (dest < nd))
    # counts stay exact past 2^24 (a float32 accumulator would not)
    n = (1 << 24) + 9
    dest = torch.zeros((1, n), dtype=torch.int32, device=dev)
    dest[0, :5] = 1
    rank, counts = partition.partition_rank(dest, 4)
    want = torch.tensor([[n - 5, 5, 0, 0]], dtype=torch.int32, device=dev)
    chk.equal("counts past 2^24", counts, want)
    chk.equal("rank past 2^24", rank[0, -1:],
              torch.tensor([n - 6], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()

    # timing at the send-path shape
    dest = torch.randint(0, WORLD + 1, (WORLD, n_local), generator=gen,
                         device=dev, dtype=torch.int32)
    offs = (torch.arange(WORLD, device=dev, dtype=torch.int32)[:, None]
            * (WORLD + 1))
    timing = {
        "shape": [WORLD, n_local], "num_dest": WORLD,
        "ms": time_ms(torch, lambda: partition.partition_rank(dest, WORLD)),
        "plain_ms": time_ms(torch,
                            lambda: ref.partition_rank_ref(dest, WORLD)),
        "library_ms": time_ms(torch, lambda: torch.bincount(
            (dest + offs).reshape(-1), minlength=WORLD * (WORLD + 1))),
        "library_call": "torch.bincount (histogram half only)",
        # read ids once, write ranks once (counts are negligible)
        "bound_ms": bound_ms(8 * dest.numel()),
    }
    return chk, timing


def check_sort(torch, dev, gen, kernel: str, seg_len: int):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitonic_sort import sort_kv_segments_bitonic
    from repro_torch.kernels.radix_sort import (sort_kv_segments_radix,
                                                sort_kv_segments_radix_ref)
    stable = kernel == "radix_sort"
    fn = sort_kv_segments_radix if stable else sort_kv_segments_bitonic
    plain = sort_kv_segments_radix_ref if stable else ref.sort_kv_segments_ref
    chk = Check(kernel)

    def compare(what, keys, vals):
        gk, gv = fn(keys, vals)
        rk, rv = plain(keys, vals)
        chk.equal(f"keys {what}", gk, rk)
        if stable:
            chk.equal(f"key bits {what}", gk.view(torch.int32),
                      rk.view(torch.int32))
            chk.equal(f"values {what}", gv, rv)
        else:
            chk.equal(f"(key, value) multiset {what}",
                      pairs_sorted(torch, gk, gv), pairs_sorted(torch, rk, rv))

    for dtype in (torch.int32, torch.uint32, torch.float32):
        for shape in ((3, 1), (17, 3), (3, 1000), (5, 4097), (2, 70001),
                      (1, 1 << 16)):
            keys = make_keys(torch, gen, shape, dtype, dev)
            vals = torch.arange(keys.numel(), dtype=torch.int32,
                                device=dev).reshape(shape)
            compare(f"{dtype} {shape}", keys, vals)
    # duplicate runs, the dtype maximum, +-0.0 and +-inf (the maximum is
    # also the bitonic padding sentinel: its payloads are compared only
    # for the stable kernel)
    dup = torch.randint(0, 4, (4, 9000), generator=gen, device=dev,
                        dtype=torch.int32)
    dup[:, ::7] = 0x7FFFFFFF
    compare("duplicates + int32 max", dup,
            torch.arange(dup.numel(), dtype=torch.int32,
                         device=dev).reshape(dup.shape))
    f = torch.tensor([[0.0, -0.0, 1.0, -0.0, float("inf"), 0.0, -1.0,
                       float("-inf"), -0.0, 0.0]] * 3, device=dev)
    compare("+-0.0 and inf", f,
            torch.arange(f.numel(), dtype=torch.int32,
                         device=dev).reshape(f.shape))
    u = torch.full((2, 5000), -1, dtype=torch.int32, device=dev)
    u[:, ::3] = 5
    compare("uint32 max", u.view(torch.uint32),
            torch.arange(u.numel(), dtype=torch.int32,
                         device=dev).reshape(u.shape))

    # the main-path segments: keys of valid records, sentinel padding
    keys = torch.randint(0, (1 << 31) - 1, (WORLD, seg_len), generator=gen,
                         device=dev, dtype=torch.int32)
    keys[:, seg_len - seg_len // 9:] = 0x7FFFFFFF
    vals = torch.arange(seg_len, dtype=torch.int32,
                        device=dev).expand(WORLD, -1).contiguous()
    compare(f"main path {(WORLD, seg_len)}", keys, vals)
    torch.cuda.synchronize()

    def library():
        s = torch.sort(keys, dim=-1, stable=True)
        return s.values, torch.gather(vals, -1, s.indices)

    timing = {
        "shape": [WORLD, seg_len],
        "ms": time_ms(torch, lambda: fn(keys, vals)),
        "plain_ms": time_ms(torch, lambda: plain(keys, vals)),
        "library_ms": time_ms(torch, library),
        "library_call": "torch.sort(stable=True) + torch.gather",
        # read keys and values once, write both once
        "bound_ms": bound_ms(16 * keys.numel()),
    }
    return chk, timing


# -- phases 4 and 5 -------------------------------------------------------------


def profile_run(torch, ex, df, records, out_dir: str):
    """Two more runs of the main path: one warm (steady-state wall time),
    one under ``torch.profiler``. From the profiled run alone: the time of
    every device-side event (kernels, copies, fills; an operator's own row
    is left out so that no time is counted twice), the union of their
    intervals, and that union's share of the profiled run's wall time.
    Writes the Chrome trace to ``out_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.run(df, records)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.run(df, records)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "main_path_trace.json"))
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


def main_path(torch, dev, gen, n_log2: int, profile_dir=None):
    from repro_torch.comm import Ranks
    from repro_torch.core.sort import SortResult, is_globally_sorted
    from repro_torch.kernels import bitonic_sort, partition, radix_sort
    from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

    n = 1 << n_log2
    n_local = n // WORLD
    keys = torch.randint(0, (1 << 31) - 1, (WORLD, n_local), generator=gen,
                         device=dev, dtype=torch.int32)
    value = torch.randint(0, 256, (WORLD, n_local, VALUE_BYTES),
                          generator=gen, device=dev, dtype=torch.uint8)
    # the first 4 value bytes carry the record's input index
    index = torch.arange(n, dtype=torch.int32, device=dev)
    value[..., :4] = index.view(torch.uint8).reshape(WORLD, n_local, 4)
    df = Dataflow.source().sort(key=lambda r: r["key"], num_buckets=WORLD,
                                capacity_factor=2.0)
    ex = SPMDExecutor(Ranks(WORLD), sort_algo="bitonic")

    for k in (partition.KERNEL, bitonic_sort.KERNEL, radix_sort.KERNEL):
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ex.run(df, {"key": keys, "value": value})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches
                for k in (partition.KERNEL, bitonic_sort.KERNEL,
                          radix_sort.KERNEL)}
    peak = torch.cuda.max_memory_allocated()

    valid = res.valid
    out_k = res.records["key"][valid]
    out_v = res.records["value"][valid]
    dropped = int(res.dropped)
    if dropped != 0:
        raise AssertionError(f"main path dropped {dropped} records")
    if out_k.numel() != n:
        raise AssertionError(f"{out_k.numel()} valid records, expected {n}")
    if not is_globally_sorted(SortResult(res.records["key"], None, valid,
                                         res.dropped), WORLD):
        raise AssertionError("main path output is not globally sorted")
    idx = out_v[:, :4].contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    if not torch.equal(torch.sort(idx).values,
                       torch.arange(n, device=dev, dtype=torch.int64)):
        raise AssertionError("delivered records are not a permutation")
    if not torch.equal(keys.reshape(-1)[idx], out_k):
        raise AssertionError("a delivered key does not match its record")
    if not torch.equal(value.reshape(n, VALUE_BYTES)[idx], out_v):
        raise AssertionError("a delivered value row does not match its key")
    for name in ("partition", "bitonic_sort"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    out = {"phase": "main_path", "records": n, "record_bytes": 4 + VALUE_BYTES,
           "ranks": WORLD, "sort_algo": "bitonic", "wall_ms": wall * 1e3,
           "records_per_s": n / wall, "peak_mem_bytes": peak,
           "launches": launches, "dropped": dropped,
           "cache": ex.cache_info()._asdict()}
    del res, out_k, out_v, idx
    if profile_dir:
        out["profile"] = profile_run(torch, ex, df,
                                     {"key": keys, "value": value},
                                     profile_dir)
    del keys, value
    torch.cuda.empty_cache()
    return out


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
                    help="log2 of the record count of the main path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile two warm reruns of the main path "
                         "and write the trace to DIR")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import bitonic_sort, build, partition, radix_sort

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels = (partition.KERNEL, bitonic_sort.KERNEL, radix_sort.KERNEL)
    built = build.build_all([k.name for k in kernels])
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "per_source_s": {k: r.seconds for k, r in built.items()}}))
    for name, r in built.items():
        for line in r.ptxas:
            log(f"  {name}: {line}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n_local = (1 << args.n_log2) // WORLD
    recv = WORLD * (int(n_local / WORLD * 2.0) + 1)   # stage-2 segment length
    checks = {}
    chk, timing = check_partition(torch, dev, gen, n_local, recv)
    checks[partition.KERNEL.name] = (chk, timing)
    for k in (bitonic_sort.KERNEL, radix_sort.KERNEL):
        checks[k.name] = check_sort(torch, dev, gen, k.name, recv)
    for name, (chk, timing) in checks.items():
        log(json.dumps({"phase": "kernel_check", "name": name,
                        "cases": chk.cases, "max_abs_err": chk.max_abs_err,
                        **timing}))
    torch.cuda.empty_cache()

    mp = main_path(torch, dev, gen, args.n_log2, args.profile)
    log(json.dumps(mp))
    shim, radix_launches = shim_runs(torch, dev, gen, args.n_log2)
    log(json.dumps({"phase": "terasort_shim", **shim}))

    rows = []
    for k in kernels:
        chk, timing = checks[k.name]
        on_main = k.name != "radix_sort"
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces,
            "launches": (mp["launches"][k.name] if on_main
                         else radix_launches),
            "path": ("dataflow sort, bitonic" if on_main
                     else "terasort sort_algo='radix'"),
            "max_abs_err": chk.max_abs_err, "tolerance": 0,
            "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": "bytes", "library_ms": timing["library_ms"],
            "shape": timing["shape"], "check": "ok"})
    log(json.dumps({"kernels": rows}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
