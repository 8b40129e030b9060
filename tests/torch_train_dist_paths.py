"""Training paths the process-rank training tests run.

Each function takes a ``ProcessRanks`` (one process of a gloo grid), runs
the sharded train step of the dense decoder
(``repro_torch.train.trainer.jit_train_step``) over the state
``init_train_state(..., ranks=)`` cuts for the process, and returns what
the tests hold to the one-process step: the losses, ``grad_norm`` and
``lr`` of each step, the collectives each step issued, the first step's
collective log and reduced gradient blocks, the process's state bytes,
and (on process 0) the parameters before the first step and after the
last, gathered whole.
No JAX here: ``tests/test_torch_train_dist.py`` runs these in spawned
CPU processes and ``tests/test_torch_cuda.py`` on the card.
"""

import dataclasses

import torch

from repro_torch.comm import ProcessRanks, model_parallel
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import build
from repro_torch.models.attention import tp_layout
from repro_torch.models.convert import named_leaves
from repro_torch.models.registry import meta_params
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (TrainState, gather_leaves,
                                       init_train_state, jit_train_step)


def cpu(tree):
    if isinstance(tree, dict):
        return {k: cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def train_run(ranks: ProcessRanks, cfg, source, batches, opt_cfg: AdamWConfig,
              accum_steps: int = 1, master: bool = False) -> dict:
    """``len(batches)`` sharded steps of ``cfg`` from the full weights
    ``source`` (a flat ``{port name: array}`` or a seeded generator);
    with ``master`` bfloat16 parameters and the float32 master copy (its
    blocks' bytes and, on process 0, the copy after the last step
    gathered whole)."""
    model = build(cfg)
    gen = source if isinstance(source, torch.Generator) else None
    params, opt = init_train_state(
        model, gen, master=master, ranks=ranks,
        source=None if gen is not None else source)
    state = TrainState(params, opt)
    step_fn, (p_specs, opt_specs, _) = jit_train_step(
        model, opt_cfg, ranks, accum_steps=accum_steps)
    shapes = {n: tuple(p.shape)
              for n, p in meta_params(cfg).named_parameters()}
    out = {"losses": [], "grad_norms": [], "lrs": [], "counts": [],
           "metrics": [], "metrics_keys": None,
           "init_params": gather_leaves(ranks, named_leaves(params, cfg),
                                        p_specs, shapes)}
    first = {}

    def keep(grads, specs):
        first["grads"] = cpu(grads)
        first["specs"] = dict(specs)

    for i, batch in enumerate(batches):
        ranks.collectives.clear()
        ranks.log = [] if i == 0 else None
        _, _, m = step_fn(state.params, state.opt, batch,
                          on_grads=keep if i == 0 else None)
        state.step += 1
        if i == 0:
            out["log"] = [dict(e) for e in ranks.log]
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["lrs"].append(float(m["lr"]))
        out["counts"].append(dict(ranks.collectives))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["metrics_keys"] = sorted(m)
    ranks.log = None
    leaves = named_leaves(state.params, cfg)
    out.update({
        "steps": state.step, "grads": first["grads"],
        "grad_specs": first["specs"], "param_specs": dict(p_specs),
        "moment_specs": dict(opt_specs["m"]),
        "local_shapes": {n: tuple(p.shape) for n, p in leaves.items()},
        "moment_shapes": {n: tuple(t.shape)
                          for n, t in state.opt["m"].items()},
        "param_bytes": nbytes(leaves.values()),
        "moment_bytes": nbytes(state.opt["m"].values())
        + nbytes(state.opt["v"].values()),
        "params": gather_leaves(ranks, leaves, p_specs, shapes)})
    if master:
        out.update({
            "master_shapes": {n: tuple(t.shape)
                              for n, t in state.opt["master"].items()},
            "master_bytes": nbytes(state.opt["master"].values()),
            "master": gather_leaves(ranks, state.opt["master"],
                                    opt_specs["m"], shapes)})
    return out


def run_cases(ranks: ProcessRanks, cases: dict, opt_cfg: AdamWConfig
              ) -> dict:
    """:func:`train_run` of every case (``{name: {"cfg", "flat",
    "batches", "accum"}}``), and :func:`split_dim_error` of
    :func:`split_dim_config`."""
    out = {name: train_run(ranks, c["cfg"], c["flat"], c["batches"],
                           opt_cfg, accum_steps=c["accum"])
           for name, c in cases.items()}
    out["split_dim"] = split_dim_error(ranks, split_dim_config())
    out["collectives"] = collectives(ranks)
    return out


def collectives(ranks) -> dict:
    """``pmax``, ``reduce_scatter`` and the ``all_gather`` along some axes
    on either backend (the stacked rows, or the process's own), counted
    from zero, and :func:`repro_torch.comm.model_parallel`."""
    import numpy as np
    ranks.collectives.clear()
    w = ranks.world
    x = ranks.stack(np.arange(w * 4 * 3, dtype=np.float32).reshape(w, 4, 3)
                    * np.array([1, -1, 2], np.float32) % 7)
    out = {"pmax": ranks.pmax(x), "model_parallel": model_parallel(ranks)}
    for a in ranks.axes:
        out[f"pmax_{a}"] = ranks.pmax(x, a)
        out[f"reduce_scatter_{a}"] = ranks.reduce_scatter(x, a)
        out[f"all_gather_{a}"] = ranks.all_gather(x, a)
    out["reduce_scatter_all"] = ranks.reduce_scatter(x, None)
    out["counts"] = dict(ranks.collectives)
    return cpu(out)


def split_dim_config():
    """KV heads that neither split whole over a model axis of 2 nor
    divide it: 3 KV heads with the heads sharded (smoke TinyLlama with 6
    heads of 8 and ``tp_size`` 2)."""
    return dataclasses.replace(get_smoke_config("tinyllama_1_1b"),
                               d_model=48, n_heads=6, n_kv_heads=3,
                               tp_size=2)


def split_dim_error(ranks: ProcessRanks, cfg) -> str:
    """The message ``jit_train_step`` raises for a KV head split over
    the model ranks ('' if it builds)."""
    try:
        jit_train_step(build(cfg), AdamWConfig(), ranks)
    except ValueError as e:
        return str(e)
    return ""


def layouts(cfg, model: int) -> list:
    """Each layer's model-parallel attention branch."""
    return [tp_layout(cfg, b.attn, model) for b in meta_params(cfg).blocks]

