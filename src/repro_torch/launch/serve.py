"""Serving launcher: bring up a model and run batched requests through the
slot-based continuous-batching engine.

Port of ``repro/launch/serve.py``, with ``--device`` (default ``cuda``);
the random weights are drawn on that device from seed 0. ``--arch`` takes
every ``ARCH_ID``; an enc-dec model (``audio``) gets random frames with
each prompt, as the JAX launcher draws them:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_moe_a2_7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_small
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b \\
      --smoke --device cpu --requests 8 --new-tokens 12
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.comm import resolve_device
from repro_torch.configs import get_config, get_smoke_config, ARCH_IDS
from repro_torch.models import build
from repro_torch.serve import Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    model = build(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, dev)
    engine = ServeEngine(model, params, batch_slots=args.slots,
                         max_len=args.max_len,
                         temperature=args.temperature)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(4, 12))
        frames = (rng.standard_normal((cfg.enc_seq, cfg.d_model))
                  .astype(np.float32) if cfg.family == "audio" else None)
        engine.submit(Request(i, prompt.astype(np.int32),
                              max_new_tokens=args.new_tokens,
                              frames=frames))
    done = engine.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    total_new = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s) on {dev}")
    for r in done[:4]:
        print(f"  req {r.req_id}: prompt[:4]={r.prompt[:4].tolist()} "
              f"-> out[:8]={r.out_tokens[:8]}")


if __name__ == "__main__":
    main()
