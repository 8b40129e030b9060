"""Checkpoint paths the process-rank checkpoint tests run.

Each process of a gloo grid on ``(2, 2)`` ``("data", "model")`` trains
every case 2 steps (``jit_train_step`` over the blocks
``init_train_state(..., ranks=)`` cuts), saves the state into one Sector
deployment the processes share (``launch.train.shared_sector``) with
``SectorCheckpointer.save(..., ranks=, specs=)``, restores it onto a
``(4, 1)`` grid built over the same processes
(``train.elastic.remesh_state``), saves it again from there, takes one
step on ``(4, 1)``, and runs two planted faults: a slice corrupted on
every copy (the restore must raise on every process), and the blocks
cut by the old grid's specs handed to the new grid (the re-save's MD5s
must differ). TinyLlama's state is also saved and restored on a grid
that keeps NCCL's rule (:func:`nccl_rule`). Returns what the tests hold
to the one-process port and the JAX package. No JAX here:
``tests/test_torch_checkpoint_ranks.py`` runs these in spawned CPU
processes.
"""

import contextlib
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.comm import ProcessRanks
from repro_torch.launch.train import shared_sector
from repro_torch.models import build
from repro_torch.models.convert import named_leaves
from repro_torch.models.registry import meta_params
from repro_torch.train.checkpoint import SectorCheckpointer, _leaves, _parts
from repro_torch.train.elastic import grid_state_specs, remesh_state
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (gather_leaves, init_train_state,
                                       jit_train_step, load_state_tree,
                                       make_state_shardings, state_tree)

#: the grid a checkpoint is restored onto
NEW_GRID = (4, 1)
PREFIX = "/ckpt/run"


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().clone()


def gathered_state(ranks, model, params, opt, master: bool) -> dict:
    """The state's leaves by ``params.<name>``, ``m.<name>``,
    ``v.<name>`` (``master.<name>``) and ``step``, assembled whole on
    process 0 (None on the others)."""
    cfg = model.cfg
    p_specs, opt_specs = make_state_shardings(
        model, dict(zip(ranks.axes, ranks.shape)), master=master)
    shapes = {n: tuple(p.shape)
              for n, p in meta_params(cfg).named_parameters()}
    out = {}
    parts = [("params", named_leaves(params, cfg), p_specs)]
    parts += [(k, opt[k], opt_specs[k]) for k in ("m", "v", "master")
              if k in opt]
    for key, tensors, specs in parts:
        got = gather_leaves(ranks, tensors, specs, shapes)
        if got is not None:
            out.update({f"{key}.{n}": t for n, t in got.items()})
    if ranks.rank != 0:
        return None
    out["step"] = _cpu(opt["step"])
    return out


def local_state(model, params, opt) -> dict:
    """This process's blocks by the names of :func:`gathered_state`."""
    out = {f"params.{n}": _cpu(p)
           for n, p in named_leaves(params, model.cfg).items()}
    for k in ("m", "v", "master"):
        if k in opt:
            out.update({f"{k}.{n}": _cpu(t) for n, t in opt[k].items()})
    out["step"] = _cpu(opt["step"])
    return out


def manifest(client, step: int) -> dict:
    return json.loads(client.download(
        f"{PREFIX}/step_{step:08d}/MANIFEST.json"))


def corrupt_slice(master, path: str) -> None:
    """Two bytes of every copy of ``path`` overwritten on the slaves."""
    for sid in master.lookup(path).locations:
        with open(master.slaves[sid]._local(path), "r+b") as f:
            f.write(b"\xff\xfe")


#: the collectives :func:`nccl_rule` guards
GUARDED = ("all_to_all_single", "all_gather_object", "barrier", "all_reduce",
           "gather", "broadcast")


@contextlib.contextmanager
def nccl_rule(ranks):
    """``ranks`` (a gloo grid) kept to NCCL's rule: its backend reads
    ``nccl``, so host tensors, objects and barriers take its own gloo
    group (``ProcessRanks.host_group``), and every collective on another
    group refuses a host tensor, an object or a barrier, as the
    launcher's default NCCL group cannot carry them. Undone on exit."""
    saved = {name: getattr(dist, name) for name in GUARDED}
    ranks.backend = "nccl"
    host = ranks.host_group()

    def guard(name, fn):
        def run(*args, group=None, **kw):
            on_host = name in ("all_gather_object", "barrier") or any(
                isinstance(a, torch.Tensor) and a.device.type == "cpu"
                for a in args)
            if on_host and group is not host:
                raise RuntimeError(f"{name}: host data on a group of the "
                                   f"device backend")
            return fn(*args, group=group, **kw)
        return run

    for name, fn in saved.items():
        setattr(dist, name, guard(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
        ranks.backend = "gloo"


def nccl_rule_case(ranks, model, params, opt, specs, client) -> dict:
    """The state saved and restored on ``ranks`` under :func:`nccl_rule`
    (``/ckpt/nccl``): the slices' MD5s, whether every restored block is
    this process's own, and what the rule refused when broken on purpose
    (host bytes over the ``model`` axis's group; over the default
    group)."""
    out = {"refused": []}
    with nccl_rule(ranks):
        ckpt = SectorCheckpointer(client, "/ckpt/nccl", num_slices=4)
        ckpt.save(2, state_tree(model, params, opt), blocking=False,
                  ranks=ranks, specs=specs)
        ckpt.wait()
        out["md5s"] = [s["md5"] for s in json.loads(client.download(
            "/ckpt/nccl/step_00000002/MANIFEST.json"))["slices"]]
        tree, _ = ckpt.restore(state_tree(model, params, opt), 2,
                               ranks=ranks, specs=specs)
        got = [p for leaf in _leaves(tree) for p in _parts(leaf)]
        want = [p for leaf in _leaves(state_tree(model, params, opt))
                for p in _parts(leaf)]
        out["restored_equal"] = len(got) == len(want) and all(
            torch.equal(a, b.detach()) for a, b in zip(got, want))
        cpu = torch.zeros(1, 2, dtype=torch.uint8)
        for axis in ("model", None):
            try:
                ranks.all_to_all_v(cpu, [1, 1], [1, 1], axis) \
                    if axis else dist.all_to_all_single(cpu[0], cpu[0])
            except (RuntimeError, ValueError) as e:
                out["refused"].append(type(e).__name__)
    return out


def run_case(ranks, new, c: dict, opt_cfg: AdamWConfig, root: str,
             emu=None) -> dict:
    cfg, master = c["cfg"], c["master"]
    model = build(cfg)
    params, opt = init_train_state(model, master=master, ranks=ranks,
                                   source=c["flat"])
    step_fn, _ = jit_train_step(model, opt_cfg, ranks)
    for b in c["batches"][:2]:
        step_fn(params, opt, b)
    out = {"state": gathered_state(ranks, model, params, opt, master),
           "rank": ranks.rank}
    sector, client, _ = shared_sector(root, ranks, lambda client: None)
    ckpt = SectorCheckpointer(client, PREFIX, num_slices=4)
    specs = grid_state_specs(model, ranks, master=master)
    ckpt.save(2, state_tree(model, params, opt), blocking=False, ranks=ranks,
              specs=specs)
    ckpt.wait()
    out["save_timings"] = dict(ckpt.timings)
    out["manifest"] = manifest(client, 2)
    out["index"] = {fm.path: (fm.size, fm.md5, sorted(fm.locations))
                    for fm in client.ls(PREFIX + "/")}
    if emu is not None:
        out["nccl_rule"] = nccl_rule_case(emu, model, params, opt, specs,
                                          client)

    # onto the new grid: its own specs, blocks of the right shapes
    fresh, fresh_opt = init_train_state(model, master=master, ranks=new,
                                        source=c["flat"])
    with torch.no_grad():
        for t in list(fresh.parameters()) + [
                t for k in ("m", "v", "master") if k in fresh_opt
                for t in fresh_opt[k].values()]:
            t.fill_(float("nan"))
    new_specs = grid_state_specs(model, new, master=master)
    like = state_tree(model, fresh, fresh_opt)
    tree, step = remesh_state(ckpt, like, new, new_specs)
    load_state_tree(model, fresh, fresh_opt, tree)
    out["restored_step"] = step
    out["restore_timings"] = dict(ckpt.timings)
    out["restored"] = local_state(model, fresh, fresh_opt)
    out["new_specs"] = make_state_shardings(
        model, dict(zip(new.axes, new.shape)), master=master)
    ckpt.save(3, state_tree(model, fresh, fresh_opt), ranks=new,
              specs=new_specs)
    out["resave"] = manifest(client, 3)

    # one step on the new grid from the restored state
    new_step, _ = jit_train_step(model, opt_cfg, new)
    _, _, m = new_step(fresh, fresh_opt, c["batches"][2])
    out["new_step"] = {k: float(v) for k, v in m.items()}
    out["after"] = gathered_state(new, model, fresh, fresh_opt, master)

    # planted fault: slice 1 of step 3 corrupted on every copy
    new.barrier()
    if new.rank == 0:
        corrupt_slice(sector, out["resave"]["slices"][1]["path"])
    new.barrier()
    t0 = time.perf_counter()
    try:
        ckpt.restore(like, 3, ranks=new, specs=new_specs)
        out["corrupt"] = ""
    except IOError as e:
        out["corrupt"] = str(e)
    out["corrupt_s"] = time.perf_counter() - t0

    # planted fault: the old grid's blocks handed to the new grid
    old, _ = ckpt.restore(state_tree(model, params, opt), 2, ranks=ranks,
                          specs=specs)
    try:
        ckpt.save(4, old, ranks=new, specs=new_specs)
        out["old_cut"] = manifest(client, 4)
    except ValueError as e:
        out["old_cut"] = str(e)
    return out


def run_cases(ranks: ProcessRanks, cases: dict, opt_cfg: AdamWConfig,
              root: str) -> dict:
    """:func:`run_case` of every case (``{name: {"cfg", "flat",
    "batches", "master"}}``), each in its own Sector deployment under
    ``root``, the new grid and a grid of ``ranks``' shape for
    :func:`nccl_rule` (TinyLlama's case) built once over the same
    processes."""
    new = ProcessRanks(NEW_GRID, ranks.axes, backend=ranks.backend,
                       device=ranks.device)
    emu = ProcessRanks(ranks.shape, ranks.axes, backend=ranks.backend,
                       device=ranks.device)
    return {name: run_case(ranks, new, c, opt_cfg, os.path.join(root, name),
                           emu if name == "tinyllama" else None)
            for name, c in cases.items()}
