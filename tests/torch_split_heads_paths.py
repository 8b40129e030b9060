"""The paths of attention whose heads split over ``model`` ranks that
``tests/test_torch_split_heads.py`` runs in gloo CPU processes.

Each process trains one sharded step of a case
(``torch_train_dist_paths.train_run``: ``jit_train_step`` over the shards
``init_train_state(..., ranks=)`` cuts) and serves it
(``torch_serve_dist_paths.rank_serve``: its blocks of the weights and
the caches, a prefill and teacher-forced decode steps), with K1's
wrapper (its plain version on the CPU) counted. No JAX here.
"""

import torch

from repro_torch.train.optimizer import AdamWConfig

import torch_serve_dist_paths as spaths
import torch_train_dist_paths as tpaths


def run_case(ranks, c: dict, opt_cfg: AdamWConfig) -> dict:
    """One case (``{"cfg", "flat", "batches", "inputs"}``): its training
    step and its serving, each with K1's calls counted."""
    train_k1, serve_k1 = [], []
    with spaths.k1_calls(train_k1):
        train = tpaths.train_run(ranks, c["cfg"], c["flat"], c["batches"],
                                 opt_cfg)
    with spaths.k1_calls(serve_k1):
        serve = spaths.rank_serve(ranks, c["cfg"], c["flat"], c["inputs"])
    train["k1_calls"], serve["k1_calls"] = len(train_k1), len(serve_k1)
    return {"train": train, "serve": serve}


def run_cases(ranks, cases: dict, opt_cfg: AdamWConfig) -> dict:
    """:func:`run_case` of every case, in this process's grid."""
    torch.manual_seed(0)
    return {name: run_case(ranks, c, opt_cfg) for name, c in cases.items()}
