#!/usr/bin/env python3
"""Where the wordcount's cold wall time goes after chip_smoke's earlier phases.

    python3 tools/wordcount_cold.py                      # every variant
    python3 tools/wordcount_cold.py --variants smoke,no_empty_cache
    python3 tools/wordcount_cold.py --out wordcount_cold.jsonl

Each variant runs twice, each time in a fresh process: once as
``chip_smoke.py`` runs it and once with the cold run under
``torch.profiler``. A process runs chip_smoke's phases in chip_smoke's
order (build, the kernel checks, K4's entry point, the flat and the
wide-area path, ``empty_cache()``) and then its wordcount, whose first run
is the cold one, with one change:

- ``smoke``: none;
- ``no_k2_edges``: K2's edge cases of phase 3 skipped;
- ``warm_scratch``: a block of K2's scratch size for the wordcount's sort
  allocated and freed (left in the allocator's cache) just before the
  cold run;
- ``no_checks``: the kernel checks of phase 3 skipped;
- ``no_paths``: K4's entry point and the flat and wide-area paths skipped;
- ``no_empty_cache``: ``torch.cuda.empty_cache()`` made a no-op, so the
  blocks the earlier phases cached serve the wordcount.

Each process prints one JSON line: the cold and warm wall times, the
device-memory segments the caching allocator mapped during the cold run
(one ``cudaMalloc`` each), the device's free memory before it and, when
profiled, the host time spent in ``cudaMalloc``. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = ("smoke", "no_k2_edges", "warm_scratch", "no_checks", "no_paths",
            "no_empty_cache")


def one(variant: str, profiled: bool, n_log2: int, seed: int) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.radix_sort import radix_plan

    if variant == "no_empty_cache":
        torch.cuda.empty_cache = lambda: None
    if variant == "no_k2_edges":
        cs.radix_edges = lambda *args: None
    dev = torch.device("cuda")
    build.build_all([k.name for k in cs.kernels()])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sh = cs.Shapes(n_log2)
    if variant != "no_checks":
        cs.check_partition(torch, dev, gen, sh)
        cs.check_sort(torch, dev, gen, "bitonic_sort", [sh.recv, sh.recv_grid],
                      sh.recv, stage2_real=sh.n_local)
        cs.check_sort(torch, dev, gen, "radix_sort", [sh.recv, sh.wc_recv],
                      sh.wc_recv)
        cs.check_bucket_hist(torch, dev, gen, sh)
    torch.cuda.empty_cache()
    if variant != "no_paths":
        keys, value = cs.make_records(torch, dev, gen, sh.n)
        cs.entry_point_k4(torch, dev, keys)
        _, flat_sorted = cs.main_path(torch, keys, value)
        cs.grid_path(torch, keys, value, flat_sorted)
        del keys, value, flat_sorted
        torch.cuda.empty_cache()
    if variant == "warm_scratch":
        plan = radix_plan(cs.WORLD, sh.wc_recv)
        block = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                            device=dev)
        del block

    seen = {}
    run_path = cs.run_path

    def cold_run(torch, ex, df, records):
        stats = torch.cuda.memory_stats
        seen["free_bytes_before"] = torch.cuda.mem_get_info()[0]
        before = stats().get("segment.all.allocated", 0)
        if not profiled:
            out = run_path(torch, ex, df, records)
        else:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = run_path(torch, ex, df, records)
            seen["cuda_malloc_ms"] = sum(
                e.self_cpu_time_total for e in prof.key_averages()
                if e.key == "cudaMalloc") / 1e3
        seen["segments_mapped"] = stats()["segment.all.allocated"] - before
        cs.run_path = run_path          # the cold run only
        return out

    cs.run_path = cold_run
    wc = cs.wordcount_path(torch, dev, seed, sh)
    return {"variant": variant, "profiled": profiled,
            "cold_wall_ms": wc["wall_ms"], "warm_wall_ms": wc["warm_wall_ms"],
            "peak_mem_bytes": wc["peak_mem_bytes"], **seen}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--n-log2", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also append the lines here")
    ap.add_argument("--one", choices=VARIANTS, help=argparse.SUPPRESS)
    ap.add_argument("--profiled", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.one:
        import torch
        if not torch.cuda.is_available():
            print("wordcount_cold: needs an NVIDIA GPU", file=sys.stderr)
            return 2
        print(json.dumps(one(args.one, args.profiled, args.n_log2,
                             args.seed)), flush=True)
        return 0

    import chip_smoke as cs
    print(cs.nvidia_smi_line(), flush=True)
    rc = 0
    for variant in args.variants.split(","):
        for profiled in (False, True):
            cmd = [sys.executable, os.path.abspath(__file__), "--one", variant,
                   "--n-log2", str(args.n_log2), "--seed", str(args.seed)]
            proc = subprocess.run(cmd + ["--profiled"] * profiled,
                                  capture_output=True, text=True, timeout=600)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(f"{variant}: exit {proc.returncode}\n"
                      f"{proc.stderr[-3000:]}", file=sys.stderr, flush=True)
                rc = 1
                continue
            print(lines[-1], flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(lines[-1] + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
