"""The dry run's programs at smoke size, traced and real.

``tests/test_torch_dryrun.py`` holds the dry run's trace of a process's
program (``repro_torch.launch.dryrun.trace``: a fake process group,
``FakeTensorMode``) to the same program run by 4 gloo CPU processes on
the same ``(2, 2)`` grid (:func:`real_programs`, given to
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
            "encdec": ("whisper_small", {})}


def config(family: str):
    arch, replace = FAMILIES[family]
    return dataclasses.replace(get_smoke_config(arch), **replace)


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
    """Every kind of each family's program on the real process group."""
    out = {}
    for fam in families:
        model = build(config(fam))
        for kind, sp in shapes(fam).items():
            got = dryrun.run_program(model, sp, ranks, ("data",))
            out[(fam, kind)] = summary(got, ranks.shape, ranks.axes,
                                       ranks.rank)
    return out


def fake_programs(families) -> dict:
    """The same programs traced (rank 0's), each on a fake grid of its
    own."""
    out = {}
    for fam in families:
        for kind, sp in shapes(fam).items():
            got = dryrun.trace(config(fam), sp, GRID, AXES)
            out[(fam, kind)] = summary(got, GRID, AXES, 0)
    return out


if __name__ == "__main__":
    torch.save(fake_programs(sys.argv[1].split(",")), sys.argv[2])
