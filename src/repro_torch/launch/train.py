"""End-to-end training driver.

Port of ``repro/launch/train.py``. Brings up the full stack: a Sector
deployment (security server, master, slaves, replication daemon), a
synthetic corpus stored as Sector slices, the Sphere-scheduled data
pipeline, the train step, and Sector-backed checkpoints with async saves
every ``--ckpt-every`` steps and a final blocking one. It prints the JAX
launcher's lines. ``--device`` (default: the card) places the model; the
weights are drawn there from seed 0. A ``--model`` axis of more than one
rank dispatches every MoE layer through the Sphere bucket shuffle (K1 on
the card).

Under ``torchrun`` (``WORLD_SIZE`` set) every process joins one
``(data, model)`` grid through ``ProcessRanks.from_env`` (``--data`` x
``--model`` must be the world; ``--backend nccl``, one card a process,
or ``gloo``): the processes share one Sector deployment under
``--workdir`` (required), each takes its rows of the global batch and
its blocks of the state (drawn from seed 0 and cut by their specs),
runs the sharded step, and saves its blocks into checkpoints in the JAX
layout (their host bytes over a gloo group of the grid beside NCCL);
process 0 prints the lines (``--log-every``: steps between two loss
lines, 10 as in the JAX launcher). A checkpoint restores onto another
grid through ``train.elastic.remesh_state`` (the JAX launcher has no
resume flag, nor has this one).

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
      --steps 16 --batch 8 --seq 2048 --ckpt-every 8
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --smoke --device cpu \\
      --data 2 --model 2 --backend gloo --steps 4 --ckpt-every 2 \\
      --workdir /tmp/run
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --data 2 --model 2 \\
      --steps 4 --seq 2048 --ckpt-every 2 --workdir /dev/shm/run  # 4 cards
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.comm import ProcessRanks
from repro_torch.configs import get_config, get_smoke_config, ARCH_IDS
from repro_torch.configs.base import ModelConfig
from repro_torch.data import (SectorDataPipeline, synthetic_tokens,
                              upload_token_dataset)
from repro_torch.launch.mesh import dp_axes_of, make_host_mesh
from repro_torch.models import build
from repro_torch.sector import (Master, NodeAddress, ReplicationDaemon,
                                SectorClient, SecurityServer, SlaveNode,
                                Topology)
from repro_torch.train.checkpoint import SectorCheckpointer
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (init_train_state, jit_train_step,
                                       state_specs, state_tree)


def make_sector(root: str, num_slaves: int = 4, replication: int = 2):
    sec = SecurityServer()
    sec.add_user("trainer", "pw")
    sec.allow_slaves("10.0.0.0/8")
    master = Master(sec, replication_factor=replication)
    topo = Topology(pods=1, racks=2, nodes_per_rack=(num_slaves + 1) // 2)
    for i in range(num_slaves):
        addr = topo.address_of(i)
        master.register_slave(SlaveNode(
            i, addr, os.path.join(root, f"slave{i}"), ip=f"10.0.0.{i + 1}"))
    client = SectorClient(master, "trainer", "pw",
                          client_addr=NodeAddress(0, 0, 0))
    return master, client, ReplicationDaemon(master)


def shared_sector(root: str, ranks, publish: Callable[[SectorClient], None],
                  num_slaves: int = 4, replication: int = 2):
    """:func:`make_sector` shared by the processes of one host: process 0
    builds its view of the slaves under ``root``, runs ``publish(client)``
    (the corpus upload) and replicates it with the daemon; after a
    barrier every other process builds its view of the same directories
    and rebuilds its index from their scan (``recover_from_scan``). No
    scan runs while another process writes."""
    if ranks.rank == 0:
        master, client, daemon = make_sector(root, num_slaves, replication)
        publish(client)
        daemon.run_until_stable()
    ranks.barrier()
    if ranks.rank != 0:
        master, client, daemon = make_sector(root, num_slaves, replication)
        master.recover_from_scan()
    ranks.barrier()
    return master, client, daemon


def train(cfg: ModelConfig, *, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-3, ckpt_every: int = 50,
          data: int = 1, model: int = 1, workdir: Optional[str] = None,
          device=None, log: Callable[[str], None] = print,
          ranks=None, log_every: int = 10) -> Dict:
    """The launcher's run: Sector, the corpus as 8 Sector slices, the
    pipeline, ``steps`` train steps (a line logged every ``log_every``),
    async checkpoints every ``ckpt_every`` steps with ``daemon.tick()``,
    the final blocking save (the last step is written once: the JAX
    launcher also saves it asynchronously when ``ckpt_every`` divides
    ``steps``, then again). Returns every piece of it (the model, the
    state and its specs, the Sector handles, the checkpointer, the train
    step) with the losses, the optimizer's metrics and each step's wall
    seconds (the step ends with reading its loss, which waits for the
    device).

    ``ranks`` is the grid, by default ``make_host_mesh(data, model,
    device)``: stacked ranks in this process. On a
    :class:`repro_torch.comm.ProcessRanks` grid of ``("data", "model")``
    (e.g. from ``torchrun``) every process runs this: one Sector
    deployment under ``workdir`` (required) shared by all
    (:func:`shared_sector`), the same global batch read by every process
    from its pipeline and cut by the step's batch specs, the state drawn
    from seed 0 and cut by its specs, and the checkpoints saved by every
    process in the JAX layout; process 0 logs and runs the daemon."""
    if ranks is None:
        ranks = make_host_mesh(data, model, device)
    procs = ranks.rows != ranks.world
    if procs and workdir is None:
        raise ValueError("processes share one Sector deployment: name its "
                         "workdir")
    first = ranks.rank == 0 if procs else True
    dev = ranks.device
    bundle = build(cfg)
    root = workdir or tempfile.mkdtemp(prefix="sector_")

    # corpus -> Sector slices
    def publish(client):
        toks = synthetic_tokens(batch * (seq + 1) * (steps + 8), cfg.vocab)
        upload_token_dataset(client, "/corpus/train", toks, num_slices=8)

    if procs:
        master, client, daemon = shared_sector(root, ranks, publish)
    else:
        master, client, daemon = make_sector(root)
        publish(client)
        daemon.run_until_stable()
    pipe = SectorDataPipeline(master, client, "/corpus/train",
                              batch=batch, seq_len=seq)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, opt = init_train_state(bundle, gen, dev,
                                   ranks=ranks if procs else None)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps)
    step_fn, (p_specs, opt_specs, _) = jit_train_step(
        bundle, opt_cfg, ranks, dp_axes=dp_axes_of(ranks) or ("data",))
    specs = state_specs(bundle, p_specs, opt_specs)

    ckpt = SectorCheckpointer(client, "/ckpt/run0", num_slices=4)
    it = iter(pipe)
    t0 = time.time()
    step = 0
    losses, metrics_log, step_s = [], [], []
    while step < steps:
        try:
            b = next(it)
        except StopIteration:
            it = iter(pipe)
            continue
        t_step = time.perf_counter()
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        params, opt, metrics = step_fn(params, opt, b)
        step += 1
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t_step)
        metrics_log.append({k: float(v) for k, v in metrics.items()})
        if first and step % log_every == 0:
            log(f"step {step:5d} loss {losses[-1]:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({(time.time() - t0) / step:.3f}s/step)")
        if step % ckpt_every == 0 and step < steps:
            ckpt.save(step, state_tree(bundle, params, opt), blocking=False,
                      ranks=ranks, specs=specs)
            if first:
                daemon.tick()
    ckpt.wait()
    ckpt.save(steps, state_tree(bundle, params, opt), ranks=ranks,
              specs=specs)
    if first:
        daemon.run_until_stable()
    return {"model": bundle, "params": params, "opt": opt,
            "opt_cfg": opt_cfg, "step_fn": step_fn, "ranks": ranks,
            "master": master, "client": client, "daemon": daemon,
            "pipe": pipe, "ckpt": ckpt, "root": root, "losses": losses,
            "metrics": metrics_log, "step_s": step_s, "specs": specs}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="process group under torchrun (WORLD_SIZE set): "
                         "nccl, one card a process, or gloo")
    ap.add_argument("--log-every", type=int, default=10,
                    help="steps between two loss lines")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    procs = "WORLD_SIZE" in os.environ
    if procs:
        world = int(os.environ["WORLD_SIZE"])
        if args.data * args.model != world:
            raise SystemExit(f"--data {args.data} x --model {args.model} "
                             f"is not the world of {world} processes")
        ranks = ProcessRanks.from_env((args.data, args.model),
                                      ("data", "model"), backend=args.backend,
                                      device=args.device)
        if ranks.device.type == "cuda":
            torch.cuda.set_device(ranks.device)
    else:
        ranks = make_host_mesh(args.data, args.model, args.device)
    run = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, ckpt_every=args.ckpt_every, workdir=args.workdir,
                log=lambda line: print(line, flush=True), ranks=ranks,
                log_every=args.log_every)
    losses = run["losses"]
    if not procs or ranks.rank == 0:
        print(f"final loss {np.mean(losses[-10:]):.4f} "
              f"(first10 {np.mean(losses[:10]):.4f}); "
              f"checkpoints: {run['ckpt'].list_steps()}", flush=True)
    if procs:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
