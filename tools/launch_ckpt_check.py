#!/usr/bin/env python3
"""Restore the last checkpoint a launcher run left in its Sector workdir,
in one process, and print what it read.

The workdir is the launcher's ``--workdir`` (4 slaves, replication 2):
a view of its slaves is built (registering a slave scans its files), the
last checkpoint under ``/ckpt/run0`` is restored into a fresh state of
the same model (every slice's MD5 checked against the manifest), and
one JSON line gives the step, the bytes, the seconds and every slice's
holders. A checkpoint written by processes under ``torchrun`` restores
so, as the one-process launcher's does.

    PYTHONPATH=src python3 tools/launch_ckpt_check.py WORKDIR \\
        [--arch tinyllama_1_1b] [--smoke] [--device cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main() -> int:
    import torch
    from repro_torch.comm import resolve_device
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.launch.train import make_sector
    from repro_torch.models import build
    from repro_torch.train.checkpoint import SectorCheckpointer
    from repro_torch.train.trainer import (init_train_state, load_state_tree,
                                           state_tree)

    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--arch", default="tinyllama_1_1b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build(cfg)
    params, opt = init_train_state(
        model, torch.Generator(device=dev).manual_seed(1), dev)
    _, client, _ = make_sector(args.workdir)
    ckpt = SectorCheckpointer(client, "/ckpt/run0")
    t0 = time.perf_counter()
    tree, step = ckpt.restore(state_tree(model, params, opt), device=dev)
    load_state_tree(model, params, opt, tree)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    manifest = json.loads(client.download(
        f"/ckpt/run0/step_{step:08d}/MANIFEST.json"))
    print(json.dumps({
        "steps": ckpt.list_steps(), "restored_step": step,
        "opt_step": int(opt["step"]), "total_bytes": manifest["total_bytes"],
        "restore_s": seconds,
        "holders": {s["path"]: sorted(client.stat(s["path"]).locations)
                    for s in manifest["slices"]}}))
    return 0 if int(opt["step"]) == step else 1


if __name__ == "__main__":
    sys.exit(main())
