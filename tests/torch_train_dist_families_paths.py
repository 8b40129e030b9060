"""The MoE and MLA decoders' training paths the process-rank tests run.

Each process of a gloo grid runs ``torch_train_dist_paths.train_run``
(the sharded step of ``repro_torch.train.trainer.jit_train_step`` over
the shards ``init_train_state(..., ranks=)`` cuts) for every case, with
``kernels.ops.partition_rank`` (K1, or its plain version on the CPU)
counted, and returns what the tests hold to the references. No JAX
here: ``tests/test_torch_train_dist_families.py`` runs these in spawned
CPU processes and ``tests/test_torch_cuda.py`` on the card.
"""

import dataclasses

import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels import ops as kops
from repro_torch.models import build
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import jit_train_step

import torch_train_dist_paths as paths


def counted_run(ranks, cfg, source, batches, opt_cfg: AdamWConfig) -> dict:
    """:func:`torch_train_dist_paths.train_run`, with the calls of K1's
    wrapper counted (``k1_calls``) and the first step's metrics kept."""
    calls = []
    real = kops.partition_rank

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    kops.partition_rank = counting
    try:
        out = paths.train_run(ranks, cfg, source, batches, opt_cfg)
    finally:
        kops.partition_rank = real
    out["k1_calls"] = len(calls)
    return out


def run_cases(ranks, cases: dict, opt_cfg: AdamWConfig) -> dict:
    """:func:`counted_run` of every case (``{name: {"cfg", "flat",
    "batches"}}``), then the messages of the configs that must raise."""
    out = {name: counted_run(ranks, c["cfg"], c["flat"], c["batches"],
                             opt_cfg)
           for name, c in cases.items()}
    out["raises"] = {name: build_error(ranks, cfg)
                     for name, cfg in raising_configs().items()}
    return out


def raising_configs() -> dict:
    """Configs ``jit_train_step`` refuses on a model axis of 2: smoke
    qwen2-moe's 6 experts (the weights pad them to 16, two expert ranks
    to 6), MLA with 3 heads of 5 value columns (``wv_up``'s 15 do not
    split into 2 blocks), xLSTM with 1 head, Mamba2 with 3 (zamba2 at
    ``d_model`` 96); with smoke xLSTM, zamba2, whisper and internvl2,
    which it builds."""
    mla = get_smoke_config("minicpm3_4b")
    return {"padding": get_smoke_config("qwen2_moe_a2_7b"),
            "mla_heads": dataclasses.replace(mla, n_heads=3, n_kv_heads=3,
                                             v_head_dim=5),
            "xlstm_heads": dataclasses.replace(
                get_smoke_config("xlstm_125m"), ssm_heads=1),
            "mamba_heads": dataclasses.replace(
                get_smoke_config("zamba2_1_2b"), d_model=96),
            **{arch: get_smoke_config(arch) for arch in
               ("xlstm_125m", "zamba2_1_2b", "whisper_small",
                "internvl2_1b")}}


def build_error(ranks, cfg) -> str:
    """The message ``jit_train_step`` raises for ``cfg`` ('' if it
    builds)."""
    try:
        jit_train_step(build(cfg), AdamWConfig(), ranks)
    except ValueError as e:
        return str(e)
    return ""


def card_step(ranks, cfg, batch, opt_cfg: AdamWConfig) -> dict:
    """One sharded step on the card from weights drawn there from seed
    0, K1's launches counted (``repro_torch.kernels.partition.KERNEL``)."""
    from repro_torch.kernels import partition
    gen = torch.Generator(device=ranks.device)
    gen.manual_seed(0)
    before = partition.KERNEL.launches
    out = counted_run(ranks, cfg, gen, [batch], opt_cfg)
    out["k1_launches"] = partition.KERNEL.launches - before
    out["device"] = str(ranks.device)
    return out
