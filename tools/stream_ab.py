#!/usr/bin/env python3
"""Time ``chip_smoke.py`` phase 10's fault-free stream in two checkouts,
in turns, on one GPU.

    python3 tools/stream_ab.py OTHER

OTHER is the root of another checkout (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore``
lists). Each run is a process of its own, in the order OTHER, this,
this, OTHER, OTHER, this; each builds its kernels from its own sources
and runs its own ``chip_smoke.stream_run(storm=False)`` over the same
2^26 words (drawn once from seed 0 by the first run and kept in
``build/stream_ab_words.npy``). Prints each run's steady batch wall p50
and p99 on 8 ranks, its ``run_s`` and words/s over the wall, and the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORDS = os.path.join(ROOT, "build", "stream_ab_words.npy")

RUN = r'''
import json, os, sys
import numpy as np
tree, words = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
sys.path.insert(0, os.path.join(tree, "src"))
import torch
import chip_smoke as C
from repro_torch.kernels import build
build.build_all([k.name for k in C.kernels()])
if not os.path.exists(words):
    np.save(words, C.draw_words(0, C.STREAM_WORDS)[0])
r = C.stream_run(torch, np.load(words), storm=False)
print("RESULT", json.dumps({k: r[k] for k in (
    "steady_p50_ms_8_ranks", "steady_p99_ms_8_ranks", "run_s",
    "wall_words_per_s")}))
'''


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"other": os.path.abspath(argv[0]), "this": ROOT}
    os.makedirs(os.path.dirname(WORDS), exist_ok=True)
    for name in ("other", "this", "this", "other", "other", "this"):
        proc = subprocess.run([sys.executable, "-c", RUN, trees[name], WORDS],
                              capture_output=True, text=True,
                              cwd=trees[name])
        got = [line[len("RESULT "):] for line in proc.stdout.splitlines()
               if line.startswith("RESULT ")]
        if proc.returncode != 0 or not got:
            print(f"{name} failed:\n{proc.stderr[-2000:]}", file=sys.stderr)
            return 1
        print(json.dumps({"tree": name, **json.loads(got[0])}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
