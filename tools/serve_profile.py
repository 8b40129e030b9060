#!/usr/bin/env python3
"""Profile the serving cells of ``chip_smoke.py`` phases 12 and 13 on one
GPU.

    python3 tools/serve_profile.py [--seed 0] [--decode-steps 8]
    python3 tools/serve_profile.py --arch minicpm3_4b xlstm_125m zamba2_1_2b \
        whisper_small internvl2_1b

Builds each model at its published config on the card (random weights
from ``--seed``), one at a time: Qwen1.5-MoE-A2.7B (the default) with
phase 12's grid prefill of 8 prompts of 1024 tokens on ``Ranks(shape=(1,
8), axes=("data", "model"))``, the other families with phase 13's
prefill batch. Warms up the prefill and a few decode steps, then records
one warm prefill and ``--decode-steps`` greedy decode steps from its
caches under ``torch.profiler``. For each:
the host wall (ending in a synchronize), the device's busy time (the
union of its kernel, copy and fill intervals), the busy share, the
device events, the ``aten`` operations the host dispatched and the
operations that took most device time. Prints one JSON line each and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def summarize(torch, prof, wall_s: float) -> dict:
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if end is None or a > end:
            busy += (b - a)
            end = b
        elif b > end:
            busy += b - end
            end = b
    table = prof.key_averages()
    top = sorted(table, key=lambda k: -k.device_time_total)[:18]
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / 1e3 / (wall_s * 1e3),
            "device_events": len(events),
            "aten_ops": sum(k.count for k in table
                            if k.key.startswith("aten::")),
            "top": [(k.key[:60], k.count, k.device_time_total / 1e3)
                    for k in top]}


def profile_arch(torch, C, arch: str, args) -> None:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.comm import Ranks
    from repro_torch.configs import get_config
    from repro_torch.models import build as build_model, encdec

    dev = torch.device("cuda")
    cfg = get_config(arch)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    with torch.inference_mode():
        params = model.init(gen, dev)
        if arch == C.SERVE_ARCH:
            ranks = Ranks(shape=C.SERVE_GRID, axes=("data", "model"),
                          device=dev)
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab, (C.PREFILL_PROMPTS, C.PREFILL_LEN)).astype(
                    np.int32)).to(dev)}
        else:
            ranks = None
            batch = C.zoo_inputs(torch, dev, gen, cfg, rng)
        n_pos = batch["tokens"].shape[1] + (cfg.img_tokens
                                            if cfg.family == "vlm" else 0)
        extra = ({"enc_out": encdec.encode(params, cfg, batch["frames"])}
                 if cfg.family == "audio" else {})

        def prefill():
            caches = model.init_caches(C.PREFILL_PROMPTS,
                                       n_pos + C.DECODE_STEPS, dev)
            return model.prefill(params, batch, caches, ranks=ranks)

        def decode(n, logits, caches):
            nxt = logits[:, -1, :cfg.vocab].argmax(-1).to(torch.int32)
            for t in range(n):
                pos = torch.full((C.PREFILL_PROMPTS, 1), n_pos + t,
                                 dtype=torch.int32, device=dev)
                logits, caches = model.decode_step(
                    params, caches, {"tokens": nxt[:, None], "pos": pos,
                                     **extra})
                nxt = logits[:, -1, :cfg.vocab].argmax(-1).to(torch.int32)
            return logits, caches

        for _ in range(2):
            logits, caches = prefill()
        decode(2, logits, caches)
        torch.cuda.synchronize()
        for name, run in (("prefill", prefill),
                          (f"{args.decode_steps} decode steps",
                           lambda: decode(args.decode_steps, logits,
                                          caches))):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            print(json.dumps({"arch": arch, "run": name,
                              **summarize(torch, prof, wall)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--arch", nargs="+", default=None,
                    help="models to profile (default: phase 12's)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("serve_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import build

    build.build_all([k.name for k in C.kernels()])
    for arch in args.arch or [C.SERVE_ARCH]:
        profile_arch(torch, C, arch, args)
        torch.cuda.empty_cache()
    print(C.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
