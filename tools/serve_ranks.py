#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` alone, on one card: serving as 8
processes.

One spawn of 8 gloo processes runs phase 19's cells
(``chip_smoke.SERVE_RANKS_CELLS``: TinyLlama-1.1B, MiniCPM3-4B at 8
layers and xLSTM-125M on ``(data, model) = (2, 4)``, Qwen1.5-MoE-A2.7B
on ``(1, 8)``, Zamba2-1.2B at 12 layers on ``(2, 4)`` at ``long_500k``'s
batch of one and 524288 slots, its shared block's caches time-sharded
over ``data``), each as soon as its reference on the card in this
process is done (``chip_smoke.train_grid_path`` with phases 16-18's
training cells left out). ``--cells`` keeps the cells of the phase lines
it names (``serve_ranks_xlstm,serve_ranks_zamba2_long``). Prints each
cell's line (``chip_smoke.check_serve_ranks``: the logits', caches' and
recurrent states' differences against the reference beside their bounds
and planted faults, prefill and decode walls, collectives, gloo bytes
and seconds, peak memory a process), the phase's seconds and the card's
name and power limit; exits 1 if a check fails.

    python3 tools/serve_ranks.py [--seed 0] [--cells LINE,LINE]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", default=None,
                    help="comma-separated phase lines to keep")
    args = ap.parse_args()
    if args.cells:
        keep = args.cells.split(",")
        chip_smoke.SERVE_RANKS_CELLS = tuple(
            c for c in chip_smoke.SERVE_RANKS_CELLS if c[0] in keep)
    import torch
    if not torch.cuda.is_available():
        print("serve_ranks: no card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build_all([k.name for k in chip_smoke.kernels()])
    chip_smoke.grid_cells = lambda torch, seed: []
    t0 = time.perf_counter()
    try:
        out = chip_smoke.train_grid_path(torch, torch.device("cuda"),
                                         args.seed)
    except AssertionError as e:
        print(f"serve_ranks: {e}", file=sys.stderr)
        return 1
    for name, line in out["paths"].items():
        chip_smoke.log(json.dumps({"phase": name, **line}))
    chip_smoke.log(json.dumps({"phase": "serve_ranks", "seconds":
                               time.perf_counter() - t0,
                               "spawn_s": out["spawn_s"],
                               "references_s": out["references_s"]}))
    chip_smoke.log(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
