#!/usr/bin/env python3
"""Time K1 and K4 of two checkouts of this repository side by side on one GPU.

    python3 tools/k1_k4_trees.py OTHER [--out build/k1_k4_trees.json]

OTHER is the root of another checkout (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Each tree runs in a process of its own, in turns (OTHER, this, this,
OTHER), builds its kernels from its own sources and times its entry
points ``kernels.partition.partition_rank`` at K1's six path shapes and
``kernels.bucket_hist.bucket_histogram`` at K4's two shapes, on the same
random ids (seeded), two ways:

- ``window_ms``: CUDA events around one call (median of 10 warm calls),
  as ``chip_smoke.py`` times a kernel: the wrapper's host time before its
  launches falls inside the window;
- ``batch_ms``: CUDA events around 20 calls enqueued back to back, over
  20 (median of 5 batches): the device's time with the queue kept full.

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: (kernel, where, rows, ids a row, destinations or buckets) at 2^25 records
SHAPES = [("K1", "flat send pack", 8, 1 << 22, 8),
          ("K1", "flat stage-2 regroup", 8, (1 << 23) + 8, 1),
          ("K1", "grid stage A", 8, 1 << 22, 4),
          ("K1", "grid stage B", 8, (1 << 23) + 4, 2),
          ("K1", "grid stage-2 regroup", 8, (1 << 23) + 2, 1),
          ("K1", "wordcount shuffle", 8, 1 << 23, 8),
          ("K4", "entry point", 8, 1 << 22, 8),
          ("K4", "one row", 1, 1 << 25, 256)]

CHILD = r"""
import json, statistics, sys
import torch
from repro_torch.kernels import bucket_hist, partition
shapes = json.loads(sys.argv[1])
dev = torch.device("cuda")
out = []
for i, (kernel, where, rows, n, nd) in enumerate(shapes):
    gen = torch.Generator(device=dev)
    gen.manual_seed(i)
    ids = torch.randint(0, nd + 1, (rows, n), generator=gen, device=dev,
                        dtype=torch.int32)
    if kernel == "K1":
        fn = lambda: partition.partition_rank(ids, nd)
    else:
        fn = lambda: bucket_hist.bucket_histogram(ids, nd)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    window = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        window.append(a.elapsed_time(b))
    batch = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            fn()
        b.record()
        b.synchronize()
        batch.append(a.elapsed_time(b) / 20)
    out.append({"kernel": kernel, "where": where, "shape": [rows, n],
                "num": nd, "window_ms": statistics.median(window),
                "batch_ms": statistics.median(batch)})
print(json.dumps(out))
"""


def run_tree(root: str):
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run([sys.executable, "-c", CHILD, json.dumps(SHAPES)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"{root}: exit {res.returncode}\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    other = os.path.abspath(args.other)
    runs = [("other", run_tree(other)), ("this", run_tree(ROOT)),
            ("this", run_tree(ROOT)), ("other", run_tree(other))]
    rows = []
    for i, (kernel, where, r, n, nd) in enumerate(SHAPES):
        row = {"kernel": kernel, "where": where, "shape": [r, n], "num": nd}
        for tree in ("other", "this"):
            got = [res[i] for name, res in runs if name == tree]
            row[tree] = {k: [g[k] for g in got]
                         for k in ("window_ms", "batch_ms")}
        rows.append(row)
    line = {"tool": "k1_k4_trees", "device": smi, "other": args.other,
            "order": [name for name, _ in runs], "rows": rows}
    print(json.dumps(line))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
