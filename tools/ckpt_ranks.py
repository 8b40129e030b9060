#!/usr/bin/env python3
"""Phase 16's checkpoint path alone, on one card.

8 gloo processes on ``(data, model) = (2, 4)`` hold TinyLlama-1.1B at
its published width with phase 16's depth (``--layers``, default 11),
its weights drawn on the card from seed 0 and cut by their specs, zero
moments and a step count of 2 (no step is taken); then
``chip_smoke.rank_checkpoint``: the state saved into a Sector deployment
the processes share (4 slaves, replication 2, on ``/dev/shm``), restored
onto ``(4, 2)`` and saved again. Prints ``chip_smoke.check_rank_checkpoint``'s
line (seconds, gloo bytes a process, the Sector root's bytes) and the
card's name and power limit; exits 1 if a check fails.

    python3 tools/ckpt_ranks.py [--layers 11]
"""

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import chip_smoke  # noqa: E402


def config(layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(chip_smoke.TRAIN_ARCH),
                               num_layers=layers)


def child(ranks, root: str, layers: int) -> dict:
    import torch
    from repro_torch.models import build
    from repro_torch.train.trainer import init_train_state
    model = build(config(layers))
    gen = torch.Generator(device=ranks.device)
    gen.manual_seed(0)
    params, opt = init_train_state(model, gen, ranks=ranks)
    opt["step"].fill_(chip_smoke.TRAIN_RANKS_STEPS)
    torch.cuda.empty_cache()
    return {"rank": ranks.rank,
            "checkpoint": chip_smoke.rank_checkpoint(ranks, model, params,
                                                     opt, root)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=chip_smoke.TRAIN_RANKS_LAYERS)
    args = ap.parse_args()
    import torch
    from repro_torch.comm import spawn_ranks
    from repro_torch.models.registry import meta_params
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    cfg = config(args.layers)
    state = 12 * sum(p.numel() for p in meta_params(cfg).parameters())
    root, free, fits = chip_smoke.sector_root(2 * state + (4 << 30))
    try:
        if not fits:
            raise RuntimeError(f"{root}: {free} bytes free")
        t0 = time.perf_counter()
        results = spawn_ranks(child, chip_smoke.TRAIN_RANKS_GRID,
                              ("data", "model"), backend="gloo",
                              device="cuda", timeout_s=900,
                              args=(root, args.layers))
        line, bad = chip_smoke.check_rank_checkpoint(cfg, results)
        line.update(spawn_s=time.perf_counter() - t0, layers=args.layers,
                    device=chip_smoke.nvidia_smi_line())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(line))
    if bad:
        print("FAILED:", bad, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
