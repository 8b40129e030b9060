"""The dry run's programs at smoke size, traced and real.

``tests/test_torch_dryrun.py`` holds the dry run's trace of a process's
program (``repro_torch.launch.dryrun.trace``: a fake process group,
``FakeTensorMode``) to the same program run by 4 gloo CPU processes on
the same ``(2, 2)`` grid, or the ``(1, 4)`` one over them for the heads
split over 4 model ranks (:func:`real_programs`, given to
``comm.spawn_ranks``): one case a family and kind, each the dry run's
``run_program``. Run as a script, this file traces the cases of the
families it is given, each program on a fake grid of its own, and saves
the results (:func:`fake_programs`). No JAX here.
"""

import dataclasses
import sys

import torch

from repro_torch.configs.base import ShapeSpec, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.models import build

GRID, AXES = (2, 2), ("data", "model")
#: smoke shapes: 4 rows over 2 data ranks
SHAPES = {"train": ShapeSpec("smoke_train", 32, 4, "train"),
          "prefill": ShapeSpec("smoke_prefill", 32, 4, "prefill"),
          "decode": ShapeSpec("smoke_decode", 48, 4, "decode")}
#: the long-context decode: a batch of one, its attention caches'
#: time axis over the data ranks (``attention.TimeBlock``)
LONG = {"hybrid": ShapeSpec("smoke_long", 64, 1, "decode")}
#: family: (arch, replaced smoke config fields), each laid out by heads
#: over 2 model ranks
FAMILIES = {"dense": ("tinyllama_1_1b", {"tp_size": 2}),
            "moe": ("qwen2_moe_a2_7b", {"num_experts": 16}),
            "mla": ("minicpm3_4b", {}),
            "hybrid": ("zamba2_1_2b", {}),
            "encdec": ("whisper_small", {}),
            # heads split over 4 model ranks: 2 KV heads, half a head a
            # rank; 10 MLA heads, 2.5 a rank, cut inside the nope part
            "split_kv": ("tinyllama_1_1b", {"tp_size": 4}),
            "mla_split": ("minicpm3_4b", {
                "d_model": 80, "n_heads": 10, "n_kv_heads": 10,
                "qk_nope_dim": 16, "qk_rope_dim": 8, "v_head_dim": 8})}
#: the families traced on a grid other than ``GRID``, over the same 4
#: processes
GRIDS = {"split_kv": (1, 4), "mla_split": (1, 4)}
#: the families whose ranks attend unequal numbers of heads (2 or 3 of
#: the 10 MLA heads), so that their programs' FLOPs and bytes differ
UNEVEN = ("mla_split",)


def config(family: str):
    arch, replace = FAMILIES[family]
    return dataclasses.replace(get_smoke_config(arch), **replace)


def grid(family: str):
    return GRIDS.get(family, GRID)


def shapes(family: str) -> dict:
    """The family's programs: train, prefill, decode (and ``long``)."""
    out = dict(SHAPES)
    if family in LONG:
        out["long"] = LONG[family]
    return out


def summary(got: dict, shape, axes, rank: int) -> dict:
    """What the test compares of a program's measurements."""
    terms = dryrun.collective_terms(got["log"], shape, axes, rank)
    return {"flops": got["flops"], "flops_by_op": got["flops_by_op"],
            "calls": terms["calls"], "bytes": terms["bytes"],
            "counts": got["counts"], "k1_calls": got["k1_calls"],
            "peak_live_bytes": got["peak_live_bytes"],
            "state_live_bytes": got["state_live_bytes"],
            "ops": [e["op"] for e in got["log"]]}


def real_programs(ranks, families) -> dict:
    """Every kind of each family's program on the real process group (on
    the family's grid, built once over the same processes)."""
    from repro_torch.comm import ProcessRanks
    grids = {tuple(ranks.shape): ranks}
    out = {}
    for fam in families:
        g = grid(fam)
        if g not in grids:
            grids[g] = ProcessRanks(g, ranks.axes, backend=ranks.backend,
                                    device=ranks.device)
        rk = grids[g]
        model = build(config(fam))
        for kind, sp in shapes(fam).items():
            got = dryrun.run_program(model, sp, rk, ("data",))
            out[(fam, kind)] = summary(got, rk.shape, rk.axes, rk.rank)
    return out


def fake_programs(families) -> dict:
    """The same programs traced (rank 0's), each on a fake grid of its
    own."""
    out = {}
    for fam in families:
        for kind, sp in shapes(fam).items():
            got = dryrun.trace(config(fam), sp, grid(fam), AXES)
            out[(fam, kind)] = summary(got, grid(fam), AXES, 0)
    return out


if __name__ == "__main__":
    torch.save(fake_programs(sys.argv[1].split(",")), sys.argv[2])
