#!/usr/bin/env python3
"""Time forms of K1 (``csrc/partition.cu``) or K4 (``csrc/bucket_hist.cu``)
against each other on one GPU.

    python3 tools/kernel_forms.py k1 [--out build/k1_forms.json]
    python3 tools/kernel_forms.py k4 [--out build/k4_forms.json]

Builds the source as it stands ("kept") and variants of it, each with a
few constants changed, into ``build/kernel_forms/`` with ``nvcc`` (the
wrapper's plan is computed with the same constants). K1's forms (the
kept one: 16 warps a block, 24 ids a thread, two blocks an SM):

- ``items16``, ``items20``, ``items28``, ``items32``: 16 to 32 ids a
  thread (the tile grows with it), two blocks an SM;
- ``items16_blocks3``: 16 ids a thread, built for three blocks an SM (42
  registers);
- ``warps8``: 8-warp blocks (a 6144-id tile), four an SM;
- ``row_major``: tile ids row after row (id = row * tiles + tile), where
  the kept form interleaves the rows' tiles (id = tile * rows + row);
- ``no_look_back`` (a diagnostic, its ranks and counts wrong by design):
  every tile takes 0 for the ids before it, so nothing waits on an
  earlier tile; the time the look-back costs is the difference.

Beside K1's forms, ``clone`` times ``torch.Tensor.clone`` of the same ids:
a read and a write of the same bytes, the copy rate the card reaches.

K4's forms:

- ``per_warp``: ``kCopies = 8``, each warp of a block adds into a shared
  histogram of its own (the kept form has one a block);
- ``unroll8``: eight 16-byte loads in flight a thread, not four;
- ``blocks1024``: about 1024 blocks over all rows, not 512.

Each form is held against the plain version (K1) or ``torch.bincount``
(K4), then timed with CUDA events around batches of 20 calls (each a
memset and a launch, enqueued back to back, so the device time and not
the host's shows; the median of 5 batches, over 20) at the paths'
shapes, in turns (forms in order, then in reverse), on random ids. Prints
one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

KERNELS = {
    "k1": {
        "source": "partition",
        # name -> {C constant: value}
        "forms": {"kept": {},
                  "items16": {"kItems": "16"},
                  "items16_blocks3": {"kItems": "16", "kNarrowBlocks": "3"},
                  "items20": {"kItems": "20"},
                  "items28": {"kItems": "28"},
                  "items32": {"kItems": "32"},
                  "warps8": {"kNarrowWarps": "8", "kNarrowBlocks": "4"},
                  "row_major": {}, "no_look_back": {}},
        # name -> [(text of the source, its replacement)]
        "replace": {
            "row_major": [
                ("const long long row = g % rows;\n"
                 "  const int tile = g / rows;",
                 "const long long row = g / tiles;\n"
                 "  const int tile = g - static_cast<int>(row) * tiles;"),
                ("const long long stride = static_cast<long long>(rows) * nd;",
                 "const long long stride = nd;")],
            "no_look_back": [
                ("prefix = look_back(tile_status - stride + x, stride, "
                 "kFlagAggregate,\n                         kFlagInclusive);",
                 "prefix = 0;")]},
        # timed only: their results are wrong by design
        "diagnostic": {"no_look_back"},
        # C constant -> the wrapper module's constant
        "plan_names": {"kNarrowWarps": "NARROW_WARPS", "kItems": "ITEMS"},
        # (rows, ids a row, destinations): the send path, the flat
        # regroup, and 128 destinations (MoE's expert count)
        "shapes": [(8, 1 << 22, 8), (8, (1 << 23) + 8, 1),
                   (8, 1 << 22, 128)],
    },
    "k4": {
        "source": "bucket_hist",
        "forms": {"kept": {},
                  "per_warp": {"kCopies": "8"},
                  "unroll8": {"kUnroll": "8"},
                  "blocks1024": {"kBlocks": "1024"}},
        "plan_names": {"kBlocks": "BLOCKS"},
        "shapes": [(8, 1 << 22, 8), (1, 1 << 25, 256)],
    },
}


def build(source: str, name: str, subs: dict, replace=()) -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild
    src = (kbuild.CSRC / f"{source}.cu").read_text()
    for old, new in replace:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: text to replace not found once")
        src = src.replace(old, new)
    for const, value in subs.items():
        src, n = re.subn(rf"(constexpr (?:int|long long) {const} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise RuntimeError(f"{const} not found once in {source}.cu")
    out_dir = os.path.join(ROOT, "build", "kernel_forms")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"{source}_{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{source}_{name}.so")
    subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS,
                    f"-I{kbuild.CSRC}", "-o", lib, cu], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(lib)
    for fn in ("partition_rank_launch", "bucket_hist_launch"):
        if hasattr(dll, fn):
            getattr(dll, fn).restype = ctypes.c_int
    return dll


def plan_for(kernel: str, shape, subs: dict):
    from repro_torch.kernels import bucket_hist, partition
    module = partition if kernel == "k1" else bucket_hist
    saved = {}
    try:
        for const, value in subs.items():
            attr = KERNELS[kernel]["plan_names"].get(const)
            if attr:
                saved[attr] = getattr(module, attr)
                setattr(module, attr, int(value))
        return (partition.partition_plan(*shape) if kernel == "k1"
                else bucket_hist.hist_plan(*shape))
    finally:
        for attr, value in saved.items():
            setattr(module, attr, value)


def args_of(*vals):
    import torch
    out = []
    for v in vals:
        if isinstance(v, torch.Tensor):
            out.append(ctypes.c_void_p(v.data_ptr()))
        else:
            out.append(ctypes.c_longlong(int(v)))
    out.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("kernel_forms: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    spec = KERNELS[args.kernel]
    forms = spec["forms"]
    dev = torch.device("cuda")
    diagnostic = spec.get("diagnostic", set())
    libs = {name: build(spec["source"], name, subs,
                        spec.get("replace", {}).get(name, ()))
            for name, subs in forms.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = {}
    for rows, n, nd in spec["shapes"]:
        plans = {name: plan_for(args.kernel, (rows, n, nd), subs)
                 for name, subs in forms.items()}
        if args.kernel == "k1":
            ids = torch.randint(0, nd + 1, (rows, n), generator=gen,
                                device=dev, dtype=torch.int32)
            rank = torch.empty_like(ids)
            counts = torch.empty((rows, nd), dtype=torch.int32, device=dev)
            scratch = {name: torch.empty(p.scratch_bytes, dtype=torch.uint8,
                                         device=dev)
                       for name, p in plans.items()}
            want_rank, want_counts = ref.partition_rank_ref(ids, nd)

            def call(name):
                p = plans[name]
                return libs[name].partition_rank_launch(*args_of(
                    ids, rank, counts, scratch[name], p.scratch_bytes, rows,
                    n, nd, p.tile, p.tiles))

            def right():
                ok = ids < nd
                return (torch.equal(counts, want_counts)
                        and torch.equal(rank[ok], want_rank[ok]))
        else:
            ids = torch.randint(0, nd, (rows, n), generator=gen, device=dev,
                                dtype=torch.int32)
            out = torch.empty((rows, nd), dtype=torch.int32, device=dev)
            want = torch.bincount(
                (ids + torch.arange(rows, device=dev,
                                    dtype=torch.int32)[:, None] * nd
                 ).reshape(-1), minlength=rows * nd).reshape(rows, nd)

            def call(name):
                p = plans[name]
                return libs[name].bucket_hist_launch(*args_of(
                    ids, out, rows, n, nd, p.chunk, p.blocks_per_row))

            def right():
                return torch.equal(out.to(torch.int64), want)

        times = {name: [] for name in forms}
        for name in list(forms) + list(reversed(forms)):
            if call(name) != 0:
                raise RuntimeError(f"{name}: launch refused")
            torch.cuda.synchronize()
            if name not in diagnostic and not right():
                raise AssertionError(f"{args.kernel} {name} differs from the "
                                     f"reference at {(rows, n)}, {nd}")
            for _ in range(5):          # batches keep the queue full
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    call(name)
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / args.iters)
        results[f"({rows}, {n}) x {nd}"] = {
            name: {"ms": statistics.median(t), "min_ms": min(t),
                   "plan": plans[name]._asdict(),
                   **({"diagnostic": "results wrong by design"}
                      if name in diagnostic else {})}
            for name, t in times.items()}
        if args.kernel == "k1":
            clone = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    ids.clone()
                end.record()
                end.synchronize()
                clone.append(start.elapsed_time(end) / args.iters)
            results[f"({rows}, {n}) x {nd}"]["clone"] = {
                "ms": statistics.median(clone), "min_ms": min(clone)}
    line = {"tool": "kernel_forms", "kernel": args.kernel, "device": smi,
            "results": results}
    print(json.dumps(line))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
