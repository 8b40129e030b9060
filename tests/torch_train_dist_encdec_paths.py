"""The enc-dec (whisper) and VLM (internvl2) training paths, and the
float32 master copy, that the process-rank tests run.

Each process of a gloo grid runs ``torch_train_dist_paths.train_run``
(the sharded step of ``repro_torch.train.trainer.jit_train_step`` over
the shards ``init_train_state(..., ranks=)`` cuts) for every case, then
the first step's gradients again with every bfloat16 rounding of the
models turned off (``torch_train_dist_ssm_paths.float32_products``),
and returns what the tests hold to the references. No JAX here:
``tests/test_torch_train_dist_encdec.py`` runs these in spawned CPU
processes and ``tests/test_torch_cuda.py`` on the card.
"""

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.models.registry import meta_params
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (gather_leaves, init_train_state,
                                       jit_train_step, make_state_shardings)

import torch_train_dist_paths as paths
import torch_train_dist_ssm_paths as spaths


def train_batches(rng: np.random.Generator, toks: np.ndarray, cfg,
                   data: int) -> list:
    """Training batches of ``cfg`` from the token blocks ``toks`` (steps,
    batch, seq + 1): ``tokens`` and ``labels``; the enc-dec's stub
    ``frames`` and a ``loss_mask`` of transcript lengths, each data
    rank's rows drawn from its own range (from an eighth of the sequence
    up on the first rank, from three quarters up on the last), so that
    the data ranks' unmasked counts differ; the VLM's ``img_embeds``;
    the stub inputs normal draws rounded to bfloat16, everything numpy
    (float32 for the stubs, the mask 0 or 1)."""
    steps, batch, n = toks.shape
    seq = n - 1
    out = []
    for b in toks:
        one = {"tokens": b[:, :-1].copy(), "labels": b[:, 1:].copy()}
        if cfg.family == "audio":
            one["frames"] = _bfloat16(rng.standard_normal(
                (batch, cfg.enc_seq, cfg.d_model)))
            lo = np.repeat(np.linspace(seq // 8, seq * 3 // 4, data)
                           .astype(int), batch // data)
            lengths = rng.integers(lo, seq + 1)
            one["loss_mask"] = (np.arange(seq)[None] < lengths[:, None]
                                ).astype(np.float32)
        if cfg.family == "vlm":
            one["img_embeds"] = _bfloat16(rng.standard_normal(
                (batch, cfg.img_tokens, cfg.d_model)))
        out.append(one)
    return out


def _bfloat16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def master_init(ranks, cfg, source) -> dict:
    """The state ``init_train_state(master=True, ranks=)`` cuts from the
    float32 ``source``, gathered on process 0: the bfloat16 parameters,
    the float32 master copy, and this process's master block shapes
    beside its moments'."""
    model = build(cfg)
    params, opt = init_train_state(model, master=True, ranks=ranks,
                                   source=source)
    p_specs, opt_specs = make_state_shardings(
        model, dict(zip(ranks.axes, ranks.shape)), master=True)
    shapes = {n: tuple(p.shape)
              for n, p in meta_params(cfg).named_parameters()}
    leaves = dict(params.named_parameters())
    return {"params": gather_leaves(ranks, leaves, p_specs, shapes),
            "master": gather_leaves(ranks, opt["master"],
                                    opt_specs["master"], shapes),
            "dtypes": sorted({str(p.dtype) for p in leaves.values()}),
            "master_shapes": {n: tuple(t.shape)
                              for n, t in opt["master"].items()},
            "moment_shapes": {n: tuple(t.shape)
                              for n, t in opt["m"].items()}}


def published_build_errors(ranks) -> dict:
    """The messages ``jit_train_step`` raises for the published Whisper-
    small and InternVL2-1B on this grid ('' where it builds)."""
    out = {}
    for arch in ("whisper_small", "internvl2_1b"):
        try:
            jit_train_step(build(get_config(arch)), AdamWConfig(), ranks)
            out[arch] = ""
        except ValueError as e:
            out[arch] = str(e)
    return out


def run_cases(ranks, cases: dict, opt_cfg: AdamWConfig) -> dict:
    """:func:`torch_train_dist_paths.train_run` of every case (``{name:
    {"cfg", "flat", "batches", "master"}}``), the first step's
    ``float32_grads`` of the cases without the master copy, then
    :func:`master_init` from the ``"master_source"`` entry's weights and
    :func:`published_build_errors`."""
    cases = dict(cases)
    source = cases.pop("master_source")
    out = {}
    for name, c in cases.items():
        out[name] = paths.train_run(ranks, c["cfg"], c["flat"],
                                    c["batches"], opt_cfg,
                                    accum_steps=c["accum"],
                                    master=c["master"])
        if not c["master"] and c["accum"] == 1:
            out[name]["float32_grads"] = spaths.float32_grads(
                ranks, c["cfg"], c["flat"], c["batches"][0], opt_cfg)
    out["master_init"] = master_init(ranks, source["cfg"], source["flat"])
    out["published"] = published_build_errors(ranks)
    return out


def card_step(ranks, cfg, batch, opt_cfg: AdamWConfig) -> dict:
    """One sharded step on the card from weights drawn there from seed
    0."""
    gen = torch.Generator(device=ranks.device)
    gen.manual_seed(0)
    out = paths.train_run(ranks, cfg, gen, [batch], opt_cfg)
    out["device"] = str(ranks.device)
    return out
