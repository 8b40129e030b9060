#!/usr/bin/env python3
"""Phases 16-20 of ``chip_smoke.py`` alone, on one card: training and
serving as 8 processes, and the dry run's trace of the training cells
that ``chip_smoke.DRYRUN_CELLS`` holds.

``--cells`` keeps the phase lines it names, training
(``chip_smoke.grid_cells``) and serving (``chip_smoke.serve_cells``)
alike (``train_ranks_cells_ssm_1x8,serve_ranks_xlstm_1x8``: phase 19's
lines are ``serve_ranks_*``); without it every cell runs. A cell that
reuses the reference of its ``(2, 4)`` twin
(``chip_smoke.REUSED_REFERENCES``) computes its own where the twin is
left out. The trace runs in a subprocess on the CPU beside the cells, as
in the script. Prints each cell's line (``chip_smoke.check_train_ranks``
or ``check_serve_ranks``), phase 20's comparisons, the seconds and the
card's name and power limit; exits 1 if a check fails.

    python3 tools/grid_ranks.py [--cells LINE,LINE] [--seed 0]
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


def keep_cells(keep) -> None:
    """Leave only the phase lines in ``keep`` in phases 16-20."""
    grid_cells, serve_cells = chip_smoke.grid_cells, chip_smoke.serve_cells
    chip_smoke.grid_cells = lambda torch, seed: [
        c for c in grid_cells(torch, seed) if c["line"] in keep]
    chip_smoke.serve_cells = lambda: [c for c in serve_cells()
                                      if c["line"] in keep]
    chip_smoke.DRYRUN_CELLS = {k: v for k, v in
                               chip_smoke.DRYRUN_CELLS.items() if k in keep}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", default=None,
                    help="comma-separated phase lines to keep")
    args = ap.parse_args()
    if args.cells:
        keep_cells(args.cells.split(","))
    import torch
    if not torch.cuda.is_available():
        print("grid_ranks: no card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build_all([k.name for k in chip_smoke.kernels()])
    t0 = time.perf_counter()
    traced = chip_smoke.start_dryrun_trace() if chip_smoke.DRYRUN_CELLS \
        else None
    try:
        out = chip_smoke.train_grid_path(torch, torch.device("cuda"),
                                         args.seed)
        for name, line in out["paths"].items():
            chip_smoke.log(json.dumps({"phase": name, **line}))
        if traced is not None:
            chip_smoke.dryrun_check(traced, {
                k: out["paths"][k] for k in chip_smoke.DRYRUN_CELLS})
    except AssertionError as e:
        print(f"grid_ranks: {e}", file=sys.stderr)
        return 1
    chip_smoke.log(json.dumps({"phase": "grid_ranks", "seconds":
                               time.perf_counter() - t0,
                               "spawn_s": out["spawn_s"],
                               "references_s": out["references_s"]}))
    chip_smoke.log(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
