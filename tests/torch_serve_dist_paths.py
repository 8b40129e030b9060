"""The serving paths the process-rank serving tests run.

Each process of a gloo grid cuts its blocks of the weights
(``registry.process_params``) and of the caches (``init_caches(...,
ranks=)``), prefills its ``data`` rows of a batch and decodes teacher
forced, and returns what ``tests/test_torch_serve_dist.py`` holds to the
port's one process (or its stacked ``Ranks``) and to the JAX package:
every call's logits, the caches' blocks, ``moe_dropped``, the
collectives of each decode step and the cache bytes. No JAX here.
"""

import contextlib
import dataclasses
import os
import sys

import torch

from repro_torch.comm import ProcessRanks
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels import ops as kops
from repro_torch.models import build, encdec
from repro_torch.models.registry import process_params

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import forward_drops, routes_tap  # noqa: E402  (no JAX)

DP = ("data",)


@contextlib.contextmanager
def k1_calls(out: list):
    """Each call of K1's wrapper (its plain version on the CPU) appended
    to ``out``."""
    real = kops.partition_rank

    def counting(*a, **k):
        out.append(1)
        return real(*a, **k)

    kops.partition_rank = counting
    try:
        yield
    finally:
        kops.partition_rank = real


def serve(model, params, inputs: dict, caches, ranks=None, rows=None):
    """Prefill ``inputs["prefill"]`` into ``caches`` and decode
    ``inputs["steps"]`` teacher-forced (each a batch of ``tokens`` and
    ``pos``); ``rows``: this process's block of the batch's rows. The
    enc-dec's decode steps carry the encoder output of the prefill's
    frames. Returns ``{"logits": [prefill, step...], "dropped",
    "routes": each decode step's routing, every token's expert ids
    sorted, ``(layers, rows, k)`` (MoE),
    "counts": each decode step's collectives, "k1": K1's calls in the
    prefill and in the decode steps}``."""
    cfg = model.cfg
    rows = slice(None) if rows is None else rows
    drops, k1_prefill, k1_decode, routes = [], [], [], []
    batch = {k: v[rows] for k, v in inputs["prefill"].items()}
    out = {"logits": [], "counts": [], "routes": []}
    with torch.inference_mode(), forward_drops(drops), routes_tap(routes):
        with k1_calls(k1_prefill):
            lg, caches = model.prefill(params, batch, caches, ranks=ranks)
        out["logits"].append(lg.clone())
        routes.clear()                 # the sphere's blocks: not compared
        enc_out = (encdec.encode(params, cfg, batch["frames"], ranks)
                   if cfg.family == "audio" else None)
        for step in inputs["steps"]:
            b = {k: v[rows] for k, v in step.items()}
            if enc_out is not None:
                b["enc_out"] = enc_out
            if ranks is not None:
                ranks.collectives.clear()
            with k1_calls(k1_decode):
                lg, caches = model.decode_step(params, caches, b,
                                               ranks=ranks)
            out["logits"].append(lg.clone())
            if routes:
                out["routes"].append(torch.stack(routes))
                routes.clear()
            if ranks is not None:
                out["counts"].append(dict(ranks.collectives))
    out.update(caches=caches, dropped=drops, k1=[len(k1_prefill),
                                                 len(k1_decode)])
    return out


def rank_serve(ranks: ProcessRanks, cfg, flat: dict, inputs: dict) -> dict:
    """:func:`serve` of this process's blocks: the weights cut from
    ``flat`` (``{port name: tensor}``), the caches allocated by their
    specs, the batch's data rows (every data rank the whole row of a
    batch of one, which the specs replicate); besides, the caches' bytes
    and the decode steps' collective log."""
    model = build(cfg)
    params = process_params(cfg, ranks, source=flat)
    b = next(iter(inputs["prefill"].values())).shape[0]
    caches = model.init_caches(b, inputs["max_len"], ranks=ranks)
    rows = slice(None)
    if b > 1:
        per = b // ranks.axis_size(DP)
        start = ranks.coords[ranks.axes.index("data")] * per
        rows = slice(start, start + per)
    ranks.log = []
    out = serve(model, params, inputs, caches, ranks, rows)
    out["log"] = [e for e in ranks.log if e["op"] != "gather"]
    ranks.log = None
    leaves = (out["caches"] if isinstance(out["caches"], list)
              else [out["caches"]])
    out["cache_bytes"] = sum(t.numel() * t.element_size()
                             for c in leaves for t in c.values())
    return out


def raising_cases() -> dict:
    """What serving over ``(2, 2)`` (or a ``(1, 4)`` grid over the same
    processes, for the split KV heads) refuses, ``{name: (config, grid,
    batch)}``: three KV heads over 4 model ranks (which they neither
    split over nor divide); 3 MLA heads of 5 value columns over 2;
    smoke qwen2-moe's 6 experts (the weights pad them to 16, two expert
    ranks to 6); the MoE (16 experts) at a batch of one over 2 data
    ranks, whose one row the decode's per-expert counts would count
    twice."""
    tiny = get_smoke_config("tinyllama_1_1b")
    mla = get_smoke_config("minicpm3_4b")
    moe = get_smoke_config("qwen2_moe_a2_7b")
    return {"split_kv": (dataclasses.replace(tiny, d_model=96, n_heads=12,
                                             n_kv_heads=3, tp_size=4),
                         (1, 4), 4),
            "mla_heads": (dataclasses.replace(mla, n_heads=3, n_kv_heads=3,
                                              v_head_dim=5), (2, 2), 4),
            "padding": (moe, (2, 2), 4),
            "moe_one_row": (dataclasses.replace(moe, num_experts=16),
                            (2, 2), 1)}


def serve_error(ranks: ProcessRanks, cfg, batch: int) -> str:
    """The ``ValueError`` message serving ``cfg`` over ``ranks`` raises
    ('' if a prefill of ``batch`` rows of 8 tokens runs): drawing the
    weights, allocating the caches or the prefill."""
    model = build(cfg)
    gen = torch.Generator().manual_seed(0)
    try:
        params = model.init(gen, ranks=ranks)
        caches = model.init_caches(batch, 16, ranks=ranks)
        rows = max(batch // ranks.axis_size(DP), 1)
        with torch.inference_mode():
            model.prefill(params, {"tokens": torch.zeros(
                (rows, 8), dtype=torch.int32)}, caches, ranks=ranks)
    except ValueError as e:
        return str(e)
    return ""


def run_cases(ranks: ProcessRanks, cases: dict, raises: bool = True
              ) -> dict:
    """:func:`rank_serve` of every case (``{name: {"cfg", "flat",
    "inputs"}}``), then (with ``raises``) the messages of
    :func:`raising_cases`."""
    out = {name: rank_serve(ranks, c["cfg"], c["flat"], c["inputs"])
           for name, c in cases.items()}
    if not raises:
        return out
    grids = {tuple(ranks.shape): ranks}
    out["raises"] = {}
    for name, (cfg, grid, batch) in raising_cases().items():
        if grid not in grids:
            grids[grid] = ProcessRanks(grid, ranks.axes,
                                       backend=ranks.backend,
                                       device=ranks.device)
        out["raises"][name] = serve_error(grids[grid], cfg, batch)
    return out
