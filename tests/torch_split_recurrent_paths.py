"""The paths of xLSTM's recurrent heads and Whisper's uneven sequence
blocks over ``model`` ranks that ``tests/test_torch_split_recurrent.py``
runs in gloo CPU processes.

Each process trains one sharded step of a case
(``torch_train_dist_paths.train_run``) and serves it
(``torch_serve_dist_paths.rank_serve``: a prefill and teacher-forced
decode steps into its blocks of the caches), then joins a sequence
layout's uneven row blocks (``attention.gather_rows``) with the gradient
that reaches each padded block recorded. No JAX here.
"""

import torch

from repro_torch.comm import axis_position
from repro_torch.models import attention
from repro_torch.train.optimizer import AdamWConfig

import torch_serve_dist_paths as spaths
import torch_train_dist_paths as tpaths

#: (positions, width) of the joined rows: 30 over 4 ranks (8, 8, 8, 6
#: rows) and 5 over 4 (2, 2, 1 and an empty block)
GATHERS = ((30, 8), (5, 3))


def gather_case(ranks, S: int, d: int) -> dict:
    """``gather_rows`` of this rank's rows of a seeded ``(2, S, d)``
    whole, backward from a seeded weight: the joined rows, the
    gradient of the rank's rows and the gradient its padded block took
    in the ``all_gather``'s backward."""
    gen = torch.Generator().manual_seed(S)
    whole = torch.randn((2, S, d), generator=gen)
    weight = torch.randn((2, S, d), generator=gen)
    rows = attention.seq_rows(S, ranks.axis_size("model"),
                              axis_position(ranks, "model"))
    x = whole[:, rows].clone().requires_grad_()
    padded = []
    real = attention.gather_from

    def recorded(r, t, axis, dim):
        t.register_hook(padded.append)
        return real(r, t, axis, dim)

    attention.gather_from = recorded
    try:
        joined = attention.gather_rows(ranks, x, S)
    finally:
        attention.gather_from = real
    (joined * weight).sum().backward()
    return {"rows": (rows.start, rows.stop), "joined": joined.detach(),
            "x_grad": x.grad, "padded_grad": padded[0]}


def run_cases(ranks, cases: dict, opt_cfg: AdamWConfig) -> dict:
    """Every case's training step and serving, then :data:`GATHERS`."""
    torch.manual_seed(0)
    out = {name: {"train": tpaths.train_run(ranks, c["cfg"], c["flat"],
                                            c["batches"], opt_cfg),
                  "serve": spaths.rank_serve(ranks, c["cfg"], c["flat"],
                                             c["inputs"])}
           for name, c in cases.items()}
    out["gathers"] = {S: gather_case(ranks, S, d) for S, d in GATHERS}
    return out
