"""The SSM (xLSTM: mLSTM and sLSTM) and hybrid (zamba2: Mamba2 and its
weight-shared attention block) decoders trained over 4 gloo processes on
``(2, 2)`` ``("data", "model")`` (``jit_train_step`` over the shards
``init_train_state(..., ranks=)`` cuts) against the port's one-process
step and the JAX package's unsharded step, on the CPU.

One spawn runs both cases (``tests/torch_train_dist_ssm_paths.py``, no
JAX) with a hard ``timeout_s`` of its own, in a thread, while this
process computes the references. The cases, 3 steps each:

- ``xlstm``: smoke xLSTM, 2 mLSTM layers and 1 sLSTM, 2 heads (1 a model
  rank);
- ``zamba2``: smoke zamba2, 4 Mamba2 layers of 2 heads (1 a model rank;
  rank 0's block of ``in_zx`` holds all of z) and the shared block at
  layers 1 and 3 (sequence-parallel: 4 heads against ``tp_size`` 16).

The weights are the JAX package's ``init`` at ``PRNGKey(0)``; the
batches consecutive blocks of the repo's corpus (``synthetic_tokens``),
8 sequences of 32 tokens. The JAX step is compiled with XLA's excess
precision off (``tests/test_torch_train.py``).

Bounds (``tests/test_torch_train_dist.py``'s, for every step: these
families route nothing):

- each loss within ``ATOL_LOSS`` 2e-3 of the one-process step's and of
  the JAX step's (measured: at most 1.35e-3, xLSTM's at step 2 against
  the one-process step);
- ``grad_norm`` within ``RTOL_GNORM`` 5e-3 relative (measured: at most
  2.6e-3, zamba2's at step 3 against the JAX step);
- the first step's reduced gradient, assembled from the processes'
  blocks, within ``RTOL_GRAD`` 3% of each leaf's largest value plus
  ``ATOL_GRAD`` 1e-3 of the one-process gradient (measured: at most
  1.2%, and 7.2% of zamba2's layer-3 ``dt_bias``, whose largest value is
  3.0e-5: 2.1e-6 absolute);
- every parameter after the last step within ``2 * sum(lr)`` of theirs,
  half within ``0.005 * sum(lr)``, and 99% within ``RULE_P99`` of
  ``sum(lr)``: the trainer tests' 0.05 for xLSTM (measured 0.044
  against the one-process step, 0.045 against JAX), ``RULE_P99_ZAMBA2``
  0.1 for zamba2 (measured 0.068 against either). The cause is AdamW's
  first update, ``lr * sign(g)`` in effect: each gradient whose rounding
  flips its sign moves a weight by ``2 lr``. The references lie as far
  apart: zamba2's one-process step and the JAX step 0.072 ``sum(lr)``
  at the 99th percentile (xLSTM 0.047), and the one process's own step
  over two micro batches 0.051 from its step over the whole batch.

Exact, or all but: the processes' losses, norms and metrics agree to
the bit; every model rank holds the same bits of each leaf replicated
along ``model``; the first step's gradient with every bfloat16 rounding
of the models turned off (``float32_products``) is the one process's
within ``RTOL_FLOAT32`` 1e-4 of each leaf's largest value (measured
1.2e-5): the sharded step computes the one-process function, and the
bfloat16 bounds above are rounding alone. The collectives a step are a
count from the layer pattern (``chip_smoke.train_collectives``), no
``all_gather`` over ``model`` moves a weight, and the state's bytes are
the specs' arithmetic.
"""

import concurrent.futures
import dataclasses
import math
import os
import sys
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
from repro_torch.comm import Ranks, shard_slices, spawn_ranks, spec_axes
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data import synthetic_tokens
from repro_torch.models import build
from repro_torch.models.attention import tp_layout
from repro_torch.models.convert import flatten, named_leaves, params_from_numpy
from repro_torch.models.registry import meta_params
from repro_torch.models.ssm import (mlstm_dims, mlstm_share, tp_heads,
                                    zx_plan)
from repro_torch.models.transformer import _shared_attn_points, layer_pattern
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import (build_train_step, jit_train_step,
                                       loss_and_grads, make_state_shardings,
                                       partial_over_model)
import torch_train_dist_ssm_paths as spaths

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import train_collectives  # noqa: E402  (imports no JAX)

GRID, AXES = (2, 2), ("data", "model")
STEPS, BATCH, SEQ = 3, 8, 32
OPT = topt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
NO_EXCESS = {"xla_allow_excess_precision": False}
ATOL_LOSS = 2e-3
RTOL_GNORM = 5e-3
RTOL_GRAD, ATOL_GRAD = 0.03, 1e-3
RULE_P99, RULE_P99_ZAMBA2 = 0.05, 0.1
RTOL_FLOAT32 = 1e-4
TIMEOUT_S = 240
CASES = {"xlstm": "xlstm_125m", "zamba2": "zamba2_1_2b"}


def _batches(vocab):
    toks = synthetic_tokens(STEPS * BATCH * (SEQ + 1), vocab)
    return [{"tokens": b[:, :-1].copy(), "labels": b[:, 1:].copy()}
            for b in toks.reshape(STEPS, BATCH, SEQ + 1)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, arch in CASES.items():
        cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
        jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        out[name] = {"cfg": cfg, "jcfg": jcfg, "jparams": jparams,
                     "tree": tree, "flat": flatten(tree),
                     "batches": _batches(cfg.vocab)}
    return out


# -- the references ---------------------------------------------------------


def _port_reference(c):
    """The port's one-process step: losses, norms, lrs, the first batch's
    gradient (and under ``float32_products``) and the parameters after
    the last step."""
    cfg = c["cfg"]
    model = build(cfg)
    params = params_from_numpy(c["tree"], cfg, "cpu", dtype=torch.float32)
    b0 = _torch_batch(c["batches"][0])
    _, _, g = loss_and_grads(model, params, b0)
    out = {"grads": {n: None if t is None else t.detach().clone()
                     for n, t in g.items()},
           "float32_grads": spaths.one_process_float32_grads(cfg, params,
                                                             b0),
           "losses": [], "grad_norms": [], "lrs": []}
    state = topt.init_opt_state(named_leaves(params, cfg))
    step = build_train_step(model, OPT)
    for b in c["batches"]:
        _, _, m = step(params, state, _torch_batch(b))
        for key, k in (("losses", "loss"), ("grad_norms", "grad_norm"),
                       ("lrs", "lr")):
            out[key].append(float(m[k]))
    out["params"] = {n: p.detach() for n, p in params.named_parameters()}
    return out


def _jax_unsharded(c):
    """The JAX package's step without a mesh."""
    jstep = jax_train_step(jax_build(c["jcfg"]), jopt.AdamWConfig(
        **dataclasses.asdict(OPT)), None)
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
    """The spawn (in a thread), the references meanwhile."""
    inputs = {name: {"cfg": c["cfg"],
                     "batches": [_torch_batch(b) for b in c["batches"]],
                     "flat": {n: torch.from_numpy(np.array(v))
                              for n, v in c["flat"].items()}}
              for name, c in cases.items()}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(spawn_ranks, spaths.run_cases, GRID, AXES,
                          device="cpu", timeout_s=TIMEOUT_S,
                          args=(inputs, OPT))
        refs = {name: {"port": _port_reference(c), "jax": _jax_unsharded(c)}
                for name, c in cases.items()}
        results = job.result()
    return results, time.perf_counter() - t0, refs


@pytest.fixture(scope="module")
def spawned(runs):
    return runs[0], runs[1]


@pytest.fixture(scope="module")
def references(runs):
    return runs[2]


def _shapes(cfg):
    return {n: tuple(p.shape) for n, p in meta_params(cfg).named_parameters()}


def _assembled(results, case, name, shape, key="grads"):
    """The first step's reduced gradient of leaf ``name``, assembled from
    the processes' blocks."""
    specs = results[0][case]["grad_specs"]
    full = torch.empty(shape)
    for r, res in enumerate(results):
        full[shard_slices(shape, specs[name], GRID, AXES, r)] = \
            res[case][key][name]
    return full


def _rule(got, want, s) -> np.ndarray:
    """The trainer tests' rule's three numbers over the parameters: the
    max, the 99th percentile and the median of the differences, over
    ``s``."""
    d = torch.cat([(got[n] - want[n]).abs().reshape(-1) for n in want])
    return np.array([float(d.max()), float(torch.quantile(d, 0.99)),
                     float(d.median())]) / s


# -- the step against its references ------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_losses_and_norms_match_the_references(spawned, references, case,
                                               ref):
    results, _ = spawned
    mine = [r[case] for r in results]
    for key in ("losses", "grad_norms", "lrs", "metrics"):
        assert all(r[key] == mine[0][key] for r in mine), key
    got, want = mine[0], references[case][ref]
    dl = np.abs(np.subtract(got["losses"], want["losses"]))
    assert (dl <= ATOL_LOSS).all(), dl
    dg = np.abs(np.subtract(got["grad_norms"], want["grad_norms"]))
    assert (dg <= RTOL_GNORM * np.abs(want["grad_norms"])).all(), dg
    np.testing.assert_array_equal(got["lrs"], references[case]["port"]["lrs"])
    assert got["metrics_keys"] == ["grad_norm", "loss", "lr"]
    assert got["steps"] == STEPS


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_parameters_match_the_references(spawned, references, case, ref):
    """The trainer tests' rule, its 99% threshold at ``RULE_P99``
    (zamba2: ``RULE_P99_ZAMBA2``)."""
    results, _ = spawned
    got = results[0][case]["params"]
    assert all(r[case]["params"] is None for r in results[1:])
    s = sum(references[case]["port"]["lrs"])
    p99 = RULE_P99_ZAMBA2 if case == "zamba2" else RULE_P99
    reading = _rule(got, references[case][ref]["params"], s)
    assert (reading <= np.array([2.0, p99, 0.005])).all(), reading


@pytest.mark.parametrize("case", list(CASES))
def test_processes_start_from_the_source_weights(spawned, cases, case):
    """The blocks ``init_train_state(..., ranks=)`` cuts, gathered, are
    the JAX package's weights to the bit."""
    results, _ = spawned
    got = results[0][case]["init_params"]
    want = cases[case]["flat"]
    assert set(got) == set(want)
    for n, w in want.items():
        assert torch.equal(got[n], torch.from_numpy(np.asarray(w))), n


# -- gradients --------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_the_one_process_step(spawned, references, cases,
                                              case):
    """Every leaf's first-step gradient, assembled, within ``RTOL_GRAD``
    of its largest value plus ``ATOL_GRAD``; and every model rank holds
    the same bits of each leaf replicated along ``model``."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    specs = results[0][case]["param_specs"]
    for n, sp in specs.items():
        if "model" in spec_axes(sp):
            continue
        for data in range(GRID[0]):
            blocks = [results[data * GRID[1] + m][case]["grads"][n]
                      for m in range(GRID[1])]
            assert all(torch.equal(b, blocks[0]) for b in blocks), n
    shapes = _shapes(cfg)
    for n, w in references[case]["port"]["grads"].items():
        full = _assembled(results, case, n, shapes[n])
        err = float((full - w).abs().max())
        assert err <= RTOL_GRAD * float(w.abs().max()) + ATOL_GRAD, n


@pytest.mark.parametrize("case", list(CASES))
def test_float32_gradients_are_the_one_process_function(spawned, references,
                                                        cases, case):
    """With every bfloat16 rounding of the models turned off, each leaf's
    first-step gradient within ``RTOL_FLOAT32`` of its largest value: the
    sharded step's arithmetic is the one process's up to the order of
    float32 additions."""
    results, _ = spawned
    shapes = _shapes(cases[case]["cfg"])
    for n, w in references[case]["port"]["float32_grads"].items():
        full = _assembled(results, case, n, shapes[n], "float32_grads")
        err = float((full - w).abs().max())
        assert err <= RTOL_FLOAT32 * float(w.abs().max()), (n, err)


@pytest.mark.parametrize("case", list(CASES))
def test_partial_leaves_are_the_per_head_vectors(cases, case):
    """``partial_over_model`` marks Mamba2's ``a_log``, ``d_skip`` and
    ``dt_bias``, mLSTM's ``if_bias`` and the shared block's replicated
    attention weights (sequence-parallel at smoke size), and nothing
    else: B, C and dt's projections and sLSTM hold their whole
    gradient."""
    cfg = cases[case]["cfg"]
    specs = build(cfg).param_specs()
    got = {n for n, sp in specs.items() if partial_over_model(n, sp, cfg)}
    if case == "xlstm":
        want = {f"blocks.{i}.cell.if_bias" for i, k in
                enumerate(layer_pattern(cfg)) if k == "mlstm"}
    else:
        want = {f"blocks.{i}.mamba.{v}" for i in range(cfg.num_layers)
                for v in ("a_log", "d_skip", "dt_bias")} | {
            f"shared_attn.attn.{w}" for w in ("wq", "wk", "wv", "wo")}
    assert got == want


# -- collectives and state ----------------------------------------------------


def _zero1_leaves(cfg) -> int:
    p, o = make_state_shardings(build(cfg), dict(zip(AXES, GRID)))
    return sum(o["m"][n] != p[n] for n in p)


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_a_step_equal_the_prediction(spawned, cases, case):
    """Every step's collectives equal the count from the layer pattern
    that ``chip_smoke.py`` phase 18 also holds the card's processes to
    (``train_collectives``)."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    specs = build(cfg).param_specs()
    layout = (tp_layout(cfg, meta_params(cfg).shared_attn.attn, GRID[1])
              if case == "zamba2" else None)
    want = train_collectives(cfg, layout, len(specs), True, GRID[0],
                             _zero1_leaves(cfg))
    assert want["all_to_all"] == 3 * sum(
        k in ("mamba", "mlstm") for k in layer_pattern(cfg))
    for res in results:
        for counts in res[case]["counts"]:
            assert counts == want


@pytest.mark.parametrize("case", list(CASES))
def test_no_weight_is_gathered_over_model(spawned, cases, case):
    """The ``all_gather``s over ``model`` move activations only: sLSTM's
    input gates (forward and recompute) and output blocks, ``(B / data,
    S, 4 d / model)`` and ``(B / data, S, d / model)`` bfloat16; the
    gradient of mLSTM's q, k, v and gates, ``(B / data, S, 3 d_in /
    model + 2 H / model)`` float32; the sequence-parallel attention's
    query rows, ``(B / data, S / model, d)`` bfloat16, twice a point;
    every other runs over ``data`` (ZeRO-1's slices)."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    m = GRID[1]
    rows = BATCH // GRID[0] * SEQ
    want = []
    for kind in layer_pattern(cfg):
        if kind == "slstm":
            want += [rows * 4 * cfg.d_model // m * 2] * 2 + [
                rows * cfg.d_model // m * 2]
        if kind == "mlstm":
            d_in, H, _ = mlstm_dims(cfg)
            want.append(rows * (3 * d_in + 2 * H) // m * 4)
    want += [rows // m * cfg.d_model * 2] * 2 * len(_shared_attn_points(cfg))
    for res in results:
        gathers = [e for e in res[case]["log"] if e["op"] == "all_gather"]
        over_model = [e["bytes"] for e in gathers if e["axes"] == ["model"]]
        assert sorted(over_model) == sorted(want)
        assert all(e["axes"] in (["model"], ["data"]) for e in gathers)


@pytest.mark.parametrize("case", list(CASES))
def test_state_bytes_are_the_specs(spawned, cases, case):
    """Each process holds its parameter blocks and its ZeRO-1 moment
    blocks, in float32, and nothing more."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    shapes = _shapes(cfg)
    sizes = dict(zip(AXES, GRID))
    p, o = make_state_shardings(build(cfg), sizes)

    def nbytes(specs):
        return sum(4 * math.prod(shapes[n]) // math.prod(
            sizes[a] for a in spec_axes(specs[n])) for n in shapes)
    for res in results:
        assert res[case]["param_bytes"] == nbytes(p)
        assert res[case]["moment_bytes"] == 2 * nbytes(o["m"])


# -- layouts that do not split, and the stacked step ---------------------------


def test_zx_exchange_gives_each_rank_its_heads():
    """The ``[z | x]`` exchange's plan: at ``model`` = 2 rank 0's block is
    all of z; at 4 (Zamba2-1.2B's 4096 channels) ranks 0-1 hold only z
    and 2-3 only x; every rank receives its heads' z then x, and what a
    rank sends is what its peers receive from it."""
    for d_in, m in ((128, 2), (4096, 4), (1536, 4), (96, 3)):
        w = d_in // m
        plans = [zx_plan(d_in, m, r) for r in range(m)]
        for r, (pieces, send, recv) in enumerate(plans):
            assert sorted(pieces) == [2 * r, 2 * r + 1]
            assert sum(send) == sum(recv) == 2 * w
            assert [recv[i] == plans[i][1][r] for i in range(m)] == [True] * m
            held = ["z" if k < m else "x" for k in pieces]
            if m == 4:
                assert held == (["z", "z"] if r < 2 else ["x", "x"])
            got = [k for i in range(m) for k in plans[i][0]
                   if k % m == r]
            assert got == [r, m + r]


def test_heads_that_do_not_split_raise():
    """xLSTM-125M's 4 heads split over 4 model ranks, and over 8 or 16
    each mLSTM head spans 2 or 4 ranks (one head's rows a rank) while
    every rank runs all 4 sLSTM heads; smoke xLSTM's 1 head spans both
    of 2. Smoke zamba2 at ``d_model`` 96 (3 Mamba2 heads) does not split
    over 2, nor do 3 mLSTM heads over 2 or 4, nor 16 sLSTM heads, which
    the cache shards, over 32: ``jit_train_step`` raises for them
    (``tests/test_torch_train_dist_families.py`` on process ranks)."""
    xl = get_config("xlstm_125m")
    assert tp_heads(xl, "mlstm", 4) == tp_heads(xl, "slstm", 4) == 1
    for model, share in ((8, 2), (16, 4)):
        assert tp_heads(xl, "mlstm", model) == 1
        assert mlstm_share(xl, model) == share
        assert tp_heads(xl, "slstm", model) == 4
    assert mlstm_share(xl, 4) == 1
    one = dataclasses.replace(get_smoke_config("xlstm_125m"), ssm_heads=1)
    assert (tp_heads(one, "mlstm", 2), mlstm_share(one, 2)) == (1, 2)
    zb = get_config("zamba2_1_2b")
    assert tp_heads(zb, "mamba", 4) == 16
    with pytest.raises(ValueError, match="3 mamba heads do not split"):
        tp_heads(dataclasses.replace(get_smoke_config("zamba2_1_2b"),
                                     d_model=96), "mamba", 2)
    three = dataclasses.replace(get_smoke_config("xlstm_125m"), d_model=96,
                                ssm_heads=3)
    for model in (2, 4):
        with pytest.raises(ValueError, match=f"3 mlstm heads do not split "
                           f"over {model} ranks of the model axis"):
            tp_heads(three, "mlstm", model)
    with pytest.raises(ValueError, match="16 slstm heads do not split "
                       "over 32"):
        tp_heads(dataclasses.replace(xl, ssm_heads=16), "slstm", 32)


def test_mamba2_gradient_is_finite_where_the_reference_overflows():
    """The SSD chunk's decay ``exp(cum_a[t] - cum_a[s])`` overflows in its
    upper triangle (``s > t``, masked) once the decay across a chunk
    passes ~88: at Zamba2-1.2B's chunk of 256, or here with ``dt`` near 1
    (``dt_bias`` = softplus^-1(1)) and ``A`` down to -16 over the smoke
    chunk of 8. The JAX package's ``where(tri, exp(diff), 0)`` then gives
    NaN gradients (``0 * inf``); the port masks before ``exp``: the same
    output, finite gradients."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm
    cfg, jcfg = get_smoke_config("zamba2_1_2b"), jax_smoke_config(
        "zamba2_1_2b")
    jp, _ = jssm.mamba2_init(jax.random.PRNGKey(0), jcfg)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"],
                                        float(np.log(np.expm1(1.0)))))
    tp = ssm.Mamba2(cfg, "cpu").trainable()
    with torch.no_grad():
        for n, p in tp.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(jp[n], np.float32)))
    x = np.random.default_rng(0).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        y, _ = jssm.mamba2_apply(p, xx.astype(jnp.bfloat16), jcfg)
        return jnp.sum(y.astype(jnp.float32)), y

    jx = jnp.asarray(x)
    (_, want), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True)).lower(
        jp, jx).compile(NO_EXCESS)(jp, jx)
    got, _ = ssm.mamba2_apply(tp, torch.from_numpy(x).to(torch.bfloat16),
                              cfg)
    grads = torch.autograd.grad(got.float().sum(), list(tp.parameters()))
    assert float(np.max(np.abs(np.asarray(want, np.float32)
                               - got.detach().float().numpy()))) <= 3e-2
    assert any(np.isnan(np.asarray(v)).any() for v in jg.values())
    assert all(torch.isfinite(g).all() for g in grads)


def test_slstm_scan_backward_is_autograds():
    """sLSTM's recurrence as one autograd node (training) against autograd
    through the plain loop (serving's), in float64: the same outputs to
    the bit, and gradients of the input gates, ``r_gates`` and the final
    states within 1e-12 of their largest values, over steps that take
    both sides of ``maximum`` (and a tie), of ``clamp`` and a carried
    final state."""
    from repro_torch.models import ssm
    g = torch.Generator().manual_seed(0)
    B, L, H, P = 3, 40, 2, 8
    wx = torch.randn((B, L, 4, H, P), generator=g, dtype=torch.float64)
    wx[:, :, 1] += 2.0
    wx[0, 0, 1, 0, :4] = wx[0, 0, 0, 0, :4]        # fm == pre_i at t = 0
    r = torch.randn((H, P, 4 * P), generator=g, dtype=torch.float64) * 0.35
    # c, n, h, m; a carried n below 1 in row 0 (from n = 1 it stays >= 1)
    state = [torch.zeros((B, H, P), dtype=torch.float64),
             torch.ones((B, H, P), dtype=torch.float64),
             torch.zeros((B, H, P), dtype=torch.float64),
             torch.zeros((B, H, P), dtype=torch.float64)]
    state[1][0] = 0.25
    w = torch.randn((B, L, H, P), generator=g, dtype=torch.float64)
    out = []
    for fn in (ssm._slstm_loop, ssm._SLSTMScan.apply):
        a, b = wx.clone().requires_grad_(), r.clone().requires_grad_()
        hs, c, n, h, m = fn(a, b, *state)
        loss = (hs * w).sum() + (0.3 * c).sum() + h.sum()
        out.append((hs.detach(), torch.autograd.grad(loss, [a, b])))
    (hs0, grads0), (hs1, grads1) = out
    assert torch.equal(hs0, hs1)
    for x, y in zip(grads0, grads1):
        assert float((x - y).abs().max()) <= 1e-12 * float(x.abs().max())
    c0, n0, h0, m0 = state
    (_, _, n_t, _), (pre_i, fm, *_) = ssm._slstm_step(wx[:, 0], h0, c0, n0,
                                                     m0, r)
    assert bool((n_t < 1).any() and (n_t > 1).any())
    assert bool((fm > pre_i).any() and (fm < pre_i).any()
                and (fm == pre_i).any())


@pytest.mark.parametrize("case", list(CASES))
def test_stacked_step_reaches_no_model_parallel_code(monkeypatch, cases,
                                                     case):
    """On stacked ranks the recurrent blocks never take a sharded path:
    with the differentiable collectives made to raise, ``jit_train_step``
    on a ``(2, 2)`` ``Ranks`` is ``build_train_step``, to the bit."""
    from repro_torch import comm

    def refuse(*a, **k):
        raise AssertionError("a stacked step reached a model-parallel path")
    for fn in (comm._CopyTo, comm._ReduceFrom, comm._GatherFrom,
               comm._Exchange, comm._ScatterSum, comm._SumBoth):
        monkeypatch.setattr(fn, "apply", refuse)
    c = cases[case]
    cfg = c["cfg"]
    ranks = Ranks(shape=GRID, axes=AXES, device="cpu")
    step, _ = jit_train_step(build(cfg), OPT, ranks)
    plain = build_train_step(build(cfg), OPT, ranks)
    out = []
    for fn in (step, plain):
        params = params_from_numpy(c["tree"], cfg, "cpu", dtype=torch.float32)
        state = topt.init_opt_state(named_leaves(params, cfg))
        _, _, m = fn(params, state, _torch_batch(c["batches"][0]))
        out.append((params, float(m["loss"])))
    (a, la), (b, lb) = out
    assert la == lb
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n


def test_spawn_is_inside_its_limit(spawned):
    _, seconds = spawned
    assert seconds < TIMEOUT_S
