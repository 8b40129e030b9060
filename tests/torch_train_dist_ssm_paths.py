"""The SSM (xLSTM) and hybrid (zamba2) decoders' training paths the
process-rank tests run.

Each process of a gloo grid runs ``torch_train_dist_paths.train_run``
(the sharded step of ``repro_torch.train.trainer.jit_train_step`` over
the shards ``init_train_state(..., ranks=)`` cuts) for every case, then
the first step's gradients again with every bfloat16 rounding of the
models turned off (:func:`float32_products`), and returns what the tests
hold to the references. No JAX here:
``tests/test_torch_train_dist_ssm.py`` runs these in spawned CPU
processes.
"""

import contextlib
import importlib
import pkgutil

import torch

import repro_torch.models
from repro_torch.models import build
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (init_train_state, jit_train_step,
                                       loss_and_grads)

import torch_train_dist_paths as paths


@contextlib.contextmanager
def float32_products():
    """Every model module's ``COMPUTE_DTYPE`` set to float32 inside the
    block: the products, the activations and the collectives' operands in
    float32, so that the sharded step and the one-process step differ only
    in the order of float32 additions."""
    mods = [importlib.import_module(f"repro_torch.models.{m.name}")
            for m in pkgutil.iter_modules(repro_torch.models.__path__)]
    mods = [m for m in mods if hasattr(m, "COMPUTE_DTYPE")]
    was = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        for m, dtype in zip(mods, was):
            m.COMPUTE_DTYPE = dtype


def float32_grads(ranks, cfg, source, batch, opt_cfg: AdamWConfig) -> dict:
    """The first step's reduced gradient blocks under
    :func:`float32_products`, by name (the update is applied to a
    throwaway state)."""
    with float32_products():
        model = build(cfg)
        params, opt = init_train_state(model, ranks=ranks, source=source)
        step_fn, _ = jit_train_step(model, opt_cfg, ranks)
        kept = {}
        step_fn(params, opt, batch,
                on_grads=lambda g, specs: kept.update(paths.cpu(g)))
    return kept


def one_process_float32_grads(cfg, params, batch) -> dict:
    """The one-process gradient of ``batch`` under
    :func:`float32_products` (``None`` where the loss does not reach a
    leaf)."""
    with float32_products():
        _, _, g = loss_and_grads(build(cfg), params, batch)
    return {n: None if t is None else t.detach().clone()
            for n, t in g.items()}


def run_cases(ranks, cases: dict, opt_cfg: AdamWConfig) -> dict:
    """:func:`torch_train_dist_paths.train_run` of every case (``{name:
    {"cfg", "flat", "batches"}}``) and its :func:`float32_grads`."""
    out = {}
    for name, c in cases.items():
        out[name] = paths.train_run(ranks, c["cfg"], c["flat"],
                                    c["batches"], opt_cfg)
        out[name]["float32_grads"] = float32_grads(
            ranks, c["cfg"], c["flat"], c["batches"][0], opt_cfg)
    return out

