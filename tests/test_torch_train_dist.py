"""The dense decoder trained over 4 gloo processes on ``(2, 2)``
``("data", "model")`` (``jit_train_step`` over the shards
``init_train_state(..., ranks=)`` cuts) against the port's one-process
step and the JAX package's unsharded step, on the CPU.

One spawn runs every case (``tests/torch_train_dist_paths.py``, no JAX),
with a hard ``timeout_s`` of its own. The cases cover the model-parallel
attention's branches: smoke TinyLlama as it is (8 heads against
``tp_size`` 16: ``_seq_shard``), and with ``tp_size=2`` (heads sharded),
granite with ``tp_size=2`` (one KV head, replicated; the plain GELU MLP)
and h2o-danube with ``tp_size=2`` (sliding window), set by
``dataclasses.replace`` in both packages; 3 steps each, and 2 steps of
TinyLlama with ``tp_size=2`` and ``accum_steps=2``. The weights are the
JAX package's ``init`` at ``PRNGKey(0)``; the batches are consecutive
blocks of the repo's training corpus (``synthetic_tokens``, the tokens
the launcher's pipeline serves), 8 sequences of 32 tokens. The JAX
step is compiled with XLA's excess precision off
(``tests/test_torch_train.py``).

Bounds (``tests/test_torch_train.py``'s; the gradients' is
``tests/test_torch_train_models.py``'s):

- each loss within ``ATOL_LOSS`` 2e-3 of the one-process step's and of
  the JAX step's;
- every parameter after the last step within ``2 * sum(lr)`` of theirs,
  99% within ``0.05 * sum(lr)``, half within ``0.005 * sum(lr)``
  (measured: 99% within 0.043, half within 0.0027 of ``sum(lr)``; on
  uniform random tokens instead of the corpus the JAX step and the
  one-process step of smoke h2o-danube already differ by 0.051 at the
  99th percentile, so the corpus's tokens are what these bounds hold
  on);
- ``grad_norm`` within ``RTOL_GNORM`` 5e-3 relative of theirs (measured:
  at most 2.8e-3 against the one-process step and 1.5e-3 against JAX;
  the bfloat16 products' rounding, as for the loss);
- the first step's reduced gradient, assembled from the processes'
  blocks, within ``RTOL_GRAD`` 3% of each leaf's largest value plus
  ``ATOL_GRAD`` 1e-3 of the one-process gradient (measured: at most 1.2%).

Two things are exact: the processes' losses, norms and learning rates
agree to the bit, and every model rank holds the same bits of each
replicated leaf's gradient (the rule in ``repro_torch/train/trainer.py``).
The state's bytes a process equal the specs' arithmetic, and the
collectives a step equal a count from the layer count.
"""

import concurrent.futures
import dataclasses
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build as jax_build
from repro.train import optimizer as jopt
from repro.train.trainer import build_train_step as jax_train_step
from repro_torch import comm
from repro_torch.comm import Ranks, shard_slices, spawn_ranks, spec_axes
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data import synthetic_tokens
from repro_torch.models import build
from repro_torch.models.attention import tp_layout
from repro_torch.models.convert import flatten, named_leaves, params_from_numpy
from repro_torch.models.registry import meta_params
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import (build_train_step, jit_train_step,
                                       loss_and_grads, partial_over_model)
import torch_train_dist_paths as paths

GRID, AXES = (2, 2), ("data", "model")
STEPS, BATCH, SEQ = 3, 8, 32
OPT = topt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
NO_EXCESS = {"xla_allow_excess_precision": False}
ATOL_LOSS = 2e-3
RTOL_GNORM = 5e-3
RTOL_GRAD, ATOL_GRAD = 0.03, 1e-3
TIMEOUT_S = 240
#: case: (arch, tp_size or None for the config's own, accum_steps, steps)
CASES = {"seq_shard": ("tinyllama_1_1b", None, 1, STEPS),
         "heads": ("tinyllama_1_1b", 2, 1, STEPS),
         "kv_replicated": ("granite_34b", 2, 1, STEPS),
         "swa": ("h2o_danube_1_8b", 2, 1, STEPS),
         "accum2": ("tinyllama_1_1b", 2, 2, 2)}
BRANCHES = {"seq_shard": "sequence", "heads": "heads",
            "kv_replicated": "heads", "swa": "heads"}


def _configs(arch, tp):
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    if tp is not None:
        cfg = dataclasses.replace(cfg, tp_size=tp)
        jcfg = dataclasses.replace(jcfg, tp_size=tp)
    return cfg, jcfg


def _batches(vocab, steps):
    toks = synthetic_tokens(steps * BATCH * (SEQ + 1), vocab)
    blocks = toks.reshape(steps, BATCH, SEQ + 1)
    return [{"tokens": b[:, :-1].copy(), "labels": b[:, 1:].copy()}
            for b in blocks]


@pytest.fixture(scope="module")
def cases():
    """Each case's configs, weights (the JAX tree and the flat numpy
    leaves by port name) and batches. ``tp_size`` changes the specs and
    not the draws: the JAX package's ``init`` runs once an arch."""
    out, weights = {}, {}
    for name, (arch, tp, accum, steps) in CASES.items():
        cfg, jcfg = _configs(arch, tp)
        if arch not in weights:
            jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
            weights[arch] = (jparams, jax.tree.map(np.asarray, jparams))
        jparams, tree = weights[arch]
        out[name] = {"cfg": cfg, "jcfg": jcfg, "jparams": jparams,
                     "tree": tree, "flat": flatten(tree), "accum": accum,
                     "batches": _batches(cfg.vocab, steps)}
    return out


def _one_process(c):
    """The port's one-process run: losses, norms, lrs, final parameters
    and the first batch's gradient."""
    cfg = c["cfg"]
    model = build(cfg)
    params = params_from_numpy(c["tree"], cfg, "cpu", dtype=torch.float32)
    b0 = {k: torch.from_numpy(v) for k, v in c["batches"][0].items()}
    if c["accum"] == 1:
        _, _, g = loss_and_grads(model, params, b0)
        grads = {n: t.detach().clone() for n, t in g.items()}
    else:
        grads = None
    state = topt.init_opt_state(named_leaves(params, cfg))
    step = build_train_step(model, OPT, accum_steps=c["accum"])
    out = {"losses": [], "grad_norms": [], "lrs": [], "grads": grads}
    for b in c["batches"]:
        _, _, m = step(params, state, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["lrs"].append(float(m["lr"]))
    out["params"] = {n: p.detach() for n, p in params.named_parameters()}
    return out


def _jax(c):
    """The JAX package's unsharded run."""
    jstep = jax_train_step(jax_build(c["jcfg"]), jopt.AdamWConfig(
        **dataclasses.asdict(OPT)), None, accum_steps=c["accum"])
    jp, js = c["jparams"], jopt.init_opt_state(c["jparams"])
    b0 = {k: jnp.asarray(v) for k, v in c["batches"][0].items()}
    fn = jax.jit(jstep).lower(jp, js, b0).compile(NO_EXCESS)
    out = {"losses": [], "grad_norms": []}
    for b in c["batches"]:
        jp, js, m = fn(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["params"] = {n: torch.from_numpy(np.asarray(v, np.float32))
                     for n, v in flatten(jax.tree.map(np.asarray,
                                                      jp)).items()}
    return out


@pytest.fixture(scope="module")
def runs(cases):
    """The spawn (started first, in a thread: the processes train while
    this one computes the references) and the references of each case,
    one-process and JAX, computed once for the cases that differ only in
    ``tp_size``, which a step without ranks does not read."""
    # weights as tensors: spawn hands tensors over in shared memory, while
    # numpy arrays go through the processes' pipes, seconds slower
    inputs = {name: {"cfg": c["cfg"], "batches": c["batches"],
                     "accum": c["accum"],
                     "flat": {n: torch.from_numpy(np.array(v))
                              for n, v in c["flat"].items()}}
              for name, c in cases.items()}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(spawn_ranks, paths.run_cases, GRID, AXES,
                          device="cpu", timeout_s=TIMEOUT_S,
                          args=(inputs, OPT))
        refs, by_run = {}, {}
        for name, c in cases.items():
            key = (c["cfg"].arch_id, c["accum"])
            if key not in by_run:
                by_run[key] = {"port": _one_process(c), "jax": _jax(c)}
            refs[name] = by_run[key]
        results = job.result()
    return results, time.perf_counter() - t0, refs


@pytest.fixture(scope="module")
def spawned(runs):
    return runs[0], runs[1]


@pytest.fixture(scope="module")
def references(runs):
    return runs[2]


def _assert_params_close(got, want, lrs):
    diffs = torch.cat([(got[n] - want[n]).abs().reshape(-1) for n in want])
    s = sum(lrs)
    assert float(diffs.max()) <= 2 * s
    assert float(torch.quantile(diffs, 0.99)) <= 0.05 * s
    assert float(diffs.median()) <= 0.005 * s


# -- the step against one process and the JAX package ----------------------


@pytest.mark.parametrize("case", list(CASES))
def test_losses_and_norms_match_one_process_and_jax(spawned, references,
                                                    case):
    results, _ = spawned
    mine = [r[case] for r in results]
    for key in ("losses", "grad_norms", "lrs"):
        assert all(r[key] == mine[0][key] for r in mine), key
    got = mine[0]
    for ref in ("port", "jax"):
        want = references[case][ref]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   atol=ATOL_LOSS, rtol=0)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                                   rtol=RTOL_GNORM, atol=0)
    np.testing.assert_array_equal(got["lrs"], references[case]["port"]["lrs"])
    assert got["metrics_keys"] == ["grad_norm", "loss", "lr"]
    assert got["steps"] == len(got["losses"])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_parameters_match_one_process_and_jax(spawned, references, case,
                                              ref):
    results, _ = spawned
    got = results[0][case]["params"]
    assert all(r[case]["params"] is None for r in results[1:])
    _assert_params_close(got, references[case][ref]["params"],
                         references[case]["port"]["lrs"])


@pytest.mark.parametrize("case", list(CASES))
def test_processes_start_from_the_one_process_weights(spawned, cases, case):
    """The blocks ``init_train_state(..., ranks=)`` cuts, gathered, are
    the source weights to the bit."""
    results, _ = spawned
    got = results[0][case]["init_params"]
    want = cases[case]["flat"]
    assert set(got) == set(want)
    for n, w in want.items():
        assert torch.equal(got[n], torch.from_numpy(np.asarray(w))), n


# -- the gradient of replicated leaves --------------------------------------


@pytest.mark.parametrize("case", list(BRANCHES))
def test_replicated_leaves_hold_the_whole_gradient(spawned, references,
                                                   cases, case):
    """Every model rank holds the same bits of a leaf replicated along
    ``model``; the blocks assembled equal the one-process gradient."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    assert paths.layouts(cfg, GRID[1]) == [BRANCHES[case]] * cfg.num_layers
    specs = results[0][case]["grad_specs"]
    want = references[case]["port"]["grads"]
    replicated = [n for n, sp in results[0][case]["param_specs"].items()
                  if "model" not in spec_axes(sp)]
    assert replicated
    for n in replicated:
        for data in range(GRID[0]):
            blocks = [results[data * GRID[1] + m][case]["grads"][n]
                      for m in range(GRID[1])]
            assert all(torch.equal(b, blocks[0]) for b in blocks), n
    for n, w in want.items():
        full = torch.empty_like(w)
        for r, res in enumerate(results):
            full[shard_slices(w.shape, specs[n], GRID, AXES, r)] = \
                res[case]["grads"][n]
        err = float((full - w).abs().max())
        assert err <= RTOL_GRAD * float(w.abs().max()) + ATOL_GRAD, n


# -- the state a process holds ------------------------------------------------


@pytest.mark.parametrize("case", ["seq_shard", "kv_replicated"])
def test_state_bytes_equal_the_specs_arithmetic(spawned, cases, case):
    """Each process's parameters are its blocks under the parameter specs
    and its moments its blocks under ``zero1_specs``: shapes and bytes."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    meta = meta_params(cfg)
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    p_specs = build(cfg).param_specs()
    m_specs = topt.zero1_specs(p_specs, shapes, ("data",),
                               dict(zip(AXES, GRID)))
    sizes = dict(zip(AXES, GRID))

    def per_rank(spec, shape):
        return math.prod(shape) // math.prod(sizes[a]
                                             for a in spec_axes(spec))
    want_p = 4 * sum(per_rank(p_specs[n], s) for n, s in shapes.items())
    want_m = 2 * 4 * sum(per_rank(m_specs[n], s) for n, s in shapes.items())
    for r, res in enumerate(results):
        got = res[case]
        assert got["param_bytes"] == want_p
        assert got["moment_bytes"] == want_m
        assert got["moment_specs"] == m_specs
        for n, s in shapes.items():
            block = shard_slices(s, m_specs[n], GRID, AXES, r)
            assert got["moment_shapes"][n] == tuple(
                len(range(d)[sl]) for d, sl in zip(s, block)), n
    # ZeRO-1 halves every moment here: each leaf has a dimension that the
    # data axis divides
    assert want_m == 2 * want_p // GRID[0]


# -- the collectives ----------------------------------------------------------


def predicted_counts(cfg, branch: str, partial: bool, n_leaves: int,
                     accum: int = 1) -> dict:
    """The collectives of one step on ``(2, 2)`` by layer count ``L``:
    per micro batch the embedding's ``reduce_from``, each layer's
    attention (a ``psum`` by head, an ``all_gather`` of the query rows
    by sequence) and MLP (a ``psum``), the cross-entropy's ``pmax`` and
    ``psum``; the backward recomputes each layer's attention collective
    (remat; its MLP ``psum`` is the block's last use and is not
    recomputed) and sums each ``copy_to``'s gradient (two a layer and the
    logits'). Then one ``psum`` of the replicated attention leaves'
    gradients where there are any, one ``reduce_scatter`` and one
    ``all_gather`` over ``data`` a leaf (ZeRO-1 shards every leaf here),
    and one ``psum`` each of the norm's squares and of the loss."""
    L = cfg.num_layers
    heads = branch == "heads"
    micro_psum = 1 + (L if heads else 0) + L + 1 + (L if heads else 0) \
        + 2 * L + 1
    micro_gather = 0 if heads else 2 * L
    return {"psum": accum * micro_psum + int(partial) + 2,
            "pmax": accum,
            "reduce_scatter": n_leaves,
            "all_gather": accum * micro_gather + n_leaves}


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_a_step_equal_the_prediction(spawned, cases, case):
    results, _ = spawned
    cfg = cases[case]["cfg"]
    branch = paths.layouts(cfg, GRID[1])[0]
    specs = build(cfg).param_specs()
    partial = any(partial_over_model(n, sp) for n, sp in specs.items())
    want = predicted_counts(cfg, branch, partial, len(specs),
                            CASES[case][2])
    for res in results:
        for counts in res[case]["counts"]:
            assert counts == want


@pytest.mark.parametrize("case", list(CASES))
def test_no_weight_is_gathered_over_model(spawned, cases, case):
    """The only ``all_gather`` over ``model`` is the sequence-parallel
    attention's: two a layer (the forward and its recompute), each moving
    one block of query rows, ``(B / data, S / model, d)`` in bfloat16;
    every other ``all_gather`` runs over ``data`` (ZeRO-1's slices)."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    accum = CASES[case][2]
    block = BATCH // accum // GRID[0] * SEQ // GRID[1] * cfg.d_model * 2
    seq = paths.layouts(cfg, GRID[1])[0] == "sequence"
    for res in results:
        gathers = [e for e in res[case]["log"] if e["op"] == "all_gather"]
        over_model = [e["bytes"] for e in gathers if e["axes"] == ["model"]]
        assert over_model == [block] * (2 * cfg.num_layers * accum * seq)
        assert all(e["axes"] in (["model"], ["data"]) for e in gathers)


# -- the new collectives, on both backends ----------------------------------


def test_new_collectives_equal_stacked(spawned):
    """``pmax``, ``reduce_scatter`` and ``all_gather`` along an axis: the
    processes' rows, in rank order, equal the stacked backend's (a
    ``pmax`` over every axis is the one value on every process); only
    the processes hold shards on ``(2, 2)``."""
    results, _ = spawned
    stacked = paths.collectives(Ranks(shape=GRID, axes=AXES, device="cpu"))
    assert stacked["model_parallel"] is False
    for key, want in stacked.items():
        got = [r["collectives"][key] for r in results]
        if key == "counts":
            assert all(g == want for g in got)
        elif key == "model_parallel":
            assert all(g is True for g in got)
        elif key == "pmax":
            assert all(torch.equal(g, want) for g in got)
        else:
            torch.testing.assert_close(torch.cat(got), want, rtol=1e-6,
                                       atol=0)


# -- what raises, and the stacked backend -------------------------------------


def test_split_dim_kv_raises(spawned):
    results, _ = spawned
    for res in results:
        assert "split-dim KV" in res["split_dim"]
    cfg = get_config("tinyllama_1_1b")
    # TinyLlama's 4 KV heads divide 16 and 8 model ranks: split-dim KV
    for model in (8, 16):
        assert tp_layout(cfg, meta_params(cfg).blocks[0].attn,
                         model) == "split_kv"
    assert tp_layout(cfg, meta_params(cfg).blocks[0].attn, 4) == "heads"


def test_stacked_ranks_step_is_unchanged(monkeypatch, cases):
    """On the stacked backend ``jit_train_step`` is ``build_train_step``
    with no model-parallel code: the dense step over a ``(2, 2)`` grid
    equals the step without ranks to the bit, with the differentiable
    collectives made to raise."""
    def refuse(*a, **k):
        raise AssertionError("a stacked step reached a model-parallel path")
    for fn in (comm._CopyTo, comm._ReduceFrom, comm._GatherFrom):
        monkeypatch.setattr(fn, "apply", refuse)
    c = cases["heads"]
    cfg = c["cfg"]
    ranks = Ranks(shape=GRID, axes=AXES, device="cpu")
    assert not comm.model_parallel(ranks)
    step, (p_specs, _, b_specs) = jit_train_step(build(cfg), OPT, ranks)
    assert p_specs == build(cfg).param_specs()
    assert b_specs == {"tokens": ("data", None), "labels": ("data", None)}
    plain = build_train_step(build(cfg), OPT)
    runs = []
    for fn in (step, plain):
        params = params_from_numpy(c["tree"], cfg, "cpu",
                                   dtype=torch.float32)
        state = topt.init_opt_state(named_leaves(params, cfg))
        for b in c["batches"]:
            _, _, m = fn(params, state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        runs.append((params, float(m["loss"])))
    (a, la), (b, lb) = runs
    assert la == lb
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n


def test_spawn_is_inside_its_limit(spawned):
    _, seconds = spawned
    assert seconds < TIMEOUT_S
