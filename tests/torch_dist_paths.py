"""Paths the process-rank tests run on both backends of ``Ranks``.

Each function takes a ``Ranks`` (stacked, every row on one device) or a
``ProcessRanks`` (one row a process) and global numpy inputs, runs one
path through the port's entry points, and returns its outputs on the
CPU: every row for ``Ranks``, the process's own for ``ProcessRanks``.
The same call on both backends is what the tests compare. No JAX here:
``tests/test_torch_dist.py`` runs these in spawned CPU processes and
``tests/test_torch_cuda.py`` on the card.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.comm import ProcessRanks
from repro_torch.core.mapreduce import default_hash, reduce_by_key_sum
from repro_torch.core.sort import terasort
from repro_torch.models import moe as moe_mod
from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor
from repro_torch.sphere.streaming import StreamExecutor

#: the wordcount's buckets (two a rank on four ranks)
WC_BUCKETS = 8


def cpu(tree):
    if isinstance(tree, dict):
        return {k: cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def rows(ranks, a):
    """Global ``(N, ...)`` rows as ``(world, N / world, ...)``, this
    backend's share of them on its device."""
    a = np.asarray(a)
    return ranks.stack(a.reshape((ranks.world, -1) + a.shape[1:]))


def collectives(ranks):
    """Every collective of the grid, on int32 and float32 inputs: along
    every axis, over every axis and over all ranks."""
    w = ranks.world
    out = {}
    x = np.arange(w * w * 3, dtype=np.int32).reshape(w, w, 3)
    xs = ranks.stack(x)
    out["all_to_all"] = ranks.all_to_all(xs)
    out["psum"] = ranks.psum(xs)
    out["psum_f32"] = ranks.psum(ranks.stack(x.astype(np.float32) / 7))
    out["all_gather"] = ranks.all_gather(xs)
    out["axis_index"] = ranks.axis_index()
    for a in ranks.axes:
        d = ranks.axis_size(a)
        y = ranks.stack(np.arange(w * d * 2, dtype=np.int32).reshape(w, d, 2)
                        * 3 + 1)
        out[f"all_to_all_{a}"] = ranks.all_to_all(y, a)
        out[f"psum_{a}"] = ranks.psum(y, a)
        out[f"axis_index_{a}"] = ranks.axis_index(a)
    if len(ranks.axes) > 1:
        out["axis_index_rev"] = ranks.axis_index(tuple(reversed(ranks.axes)))
        out["psum_all_named"] = ranks.psum(xs, tuple(ranks.axes))
    out["counts"] = dict(ranks.collectives)
    return cpu(out)


def flat_terasort(ranks, keys, payload):
    """``terasort`` on the flat axis, bitonic-pinned (K1 and K3)."""
    res = terasort(rows(ranks, keys), rows(ranks, payload), ranks,
                   use_pallas=True)
    return cpu({"keys": res.keys, "payload": res.payload, "valid": res.valid,
                "dropped": res.dropped, "counts": dict(ranks.collectives)})


def record_sort(ranks, keys, value, axes=None):
    """The 100-byte-record sort of ``chip_smoke.py`` phases 5-6 at test
    size: ``Dataflow.source().sort`` over ``axes`` (two axes: the
    hierarchical shuffle)."""
    df = Dataflow.source().sort(key=lambda r: r["key"],
                                num_buckets=ranks.world)
    ex = SPMDExecutor(ranks, axes=axes, sort_algo="bitonic")
    res = ex.run(df, {"key": rows(ranks, keys), "value": rows(ranks, value)})
    return cpu({"key": res.records["key"], "value": res.records["value"],
                "valid": res.valid, "dropped": res.dropped,
                "counts": dict(ranks.collectives)})


def wordcount_pipeline(stream: bool = False):
    src = Dataflow.stream_source() if stream else Dataflow.source()
    return (src.map(lambda r: {"key": r["word"],
                               "value": torch.ones_like(r["word"])})
            .shuffle(by=lambda r: default_hash(r["key"], WC_BUCKETS),
                     num_buckets=WC_BUCKETS, capacity_factor=4.0)
            .reduce(_count))


def _count(rec, valid):
    k, s, d = reduce_by_key_sum(rec["key"], rec["value"], valid,
                                algo="radix")
    return {"key": k, "value": s}, k >= 0, d


def wordcount(ranks, words):
    """The MapReduce wordcount (K1 and K2 on the card)."""
    res = SPMDExecutor(ranks).run(wordcount_pipeline(),
                                  {"word": rows(ranks, words)})
    return cpu({"key": res.records["key"], "value": res.records["value"],
                "valid": res.valid, "dropped": res.dropped,
                "counts": dict(ranks.collectives)})


def stream_batches(ranks, words, micro_batch: int, carry: int):
    """Two micro-batches of the carried wordcount stream: the batches'
    records and the carry's valid rows after each (rank-major)."""
    ex = StreamExecutor(SPMDExecutor(ranks), wordcount_pipeline(True),
                        micro_batch=micro_batch, carry_capacity=carry)
    out = {}
    for i in range(2):
        ex.submit({"word": words[i * micro_batch:(i + 1) * micro_batch]})
        b = ex.step(now=float(i))
        out[f"batch{i}"] = cpu({"key": b.records["key"],
                                "value": b.records["value"],
                                "valid": b.valid})
        out[f"dropped{i}"] = b.dropped
        out[f"carry{i}"] = ex.carry_state()
    out["counts"] = dict(ranks.collectives)
    return out


def moe_layer(ranks, cfg, x, seed: int = 0, chunks: int = 1):
    """One sphere MoE layer over ``("data", "model")``: weights drawn from
    ``seed`` on the ranks' device (every process draws all of them, then
    keeps its experts), ``x`` the global input. Returns the output (the
    process's block under process ranks), ``moe_aux``, ``moe_dropped``,
    the routing of every token the backend holds and its per-expert
    counts."""
    gen = torch.Generator(device=ranks.device)
    gen.manual_seed(seed)
    layer = moe_mod.MoE(cfg, device=ranks.device)
    layer.init_weights(gen)
    full = dict(layer.named_parameters())
    local = isinstance(ranks, ProcessRanks)
    params = moe_mod.local_params(full, layer.specs, ranks) if local else full
    xt = torch.as_tensor(x).to(ranks.device)
    with torch.no_grad():
        out, metrics = moe_mod.moe_apply_sphere(params, xt, cfg, ranks,
                                                ("data",), chunks=chunks)
        if local:
            xt = moe_mod.token_block(xt, *ranks.shape, ranks.rank)
        top_i, _, _ = moe_mod._route(full, xt.reshape(-1, xt.shape[-1]), cfg)
    e_pad = full["w_gate"].shape[0]
    return cpu({"out": out, "aux": metrics["moe_aux"],
                "dropped": metrics["moe_dropped"], "top_i": top_i,
                "per_expert": torch.bincount(top_i.reshape(-1).long(),
                                             minlength=e_pad),
                "counts": dict(ranks.collectives)})


def moe_config(cfg, num_experts: int = 16):
    """A smoke MoE config whose experts pad alike for 16 and for 4 expert
    ranks (60 do not: the port raises there, as the JAX package fails)."""
    return dataclasses.replace(cfg, num_experts=num_experts)
