"""The enc-dec (whisper: the encoder, causal and cross attention without
rope) and VLM (internvl2: the image tokens in front of the text) families
trained over 4 gloo processes on ``(2, 2)`` ``("data", "model")``
(``jit_train_step`` over the shards ``init_train_state(..., ranks=)``
cuts), with a masked loss and with the float32 master copy, against the
port's one-process step and the JAX package's unsharded step, on the
CPU.

One spawn runs every case (``tests/torch_train_dist_encdec_paths.py``,
no JAX) with a hard ``timeout_s`` of its own, in a thread, while this
process computes the references. The cases, 3 steps each:

- ``whisper``: smoke whisper, 2 encoder and 2 decoder layers of 4 heads
  against ``tp_size`` 16 (the sequence layout: 16 encoder frames and 16
  decoder positions a model rank), its batches carrying a ``loss_mask``
  of transcript lengths drawn from the seed, the first data rank's from
  4 tokens up and the second's from 24, so their unmasked counts differ;
- ``whisper_heads``: the same with ``tp_size=2`` (the heads layout: 2
  heads a model rank, the cross keys and values of its 2 KV heads), held
  to ``whisper``'s references (``tp_size`` changes the specs, not the
  function);
- ``whisper_accum2``: ``whisper`` with ``accum_steps=2``, each micro
  batch's masked mean over its own global count, as the JAX package's
  scan averages the micro batches' means (its references the one
  process's and the JAX step over two micro batches);
- ``internvl2``: smoke internvl2, 8 image tokens in front of 32 text
  tokens, 2 layers of 4 heads (sequence layout), the loss on the text;
- ``tinyllama_master``: smoke TinyLlama with bfloat16 parameters and the
  float32 master copy, ZeRO-1-sharded like the moments, against the one
  process's and the JAX package's ``init_opt_state(master=True)`` on
  bfloat16 parameters (``tests/test_train.py``'s call); the processes
  start from the JAX package's bfloat16 weights, whose float32 values
  are its master copy.

The weights are the JAX package's ``init`` at ``PRNGKey(0)``; the tokens
consecutive blocks of the repo's corpus (``synthetic_tokens``), 8
sequences of 32; the stub frames and image embeddings normal draws from
the seed, rounded to bfloat16. The JAX step is compiled with XLA's
excess precision off (``tests/test_torch_train.py``).

Bounds (``tests/test_torch_train_dist.py``'s, for every step):

- each loss within ``ATOL_LOSS`` 2e-3 of the one-process step's and of
  the JAX step's;
- ``grad_norm`` within ``RTOL_GNORM`` 5e-3 relative;
- the first step's reduced gradient, assembled from the processes'
  blocks, within ``RTOL_GRAD`` 3% of each leaf's largest value plus
  ``ATOL_GRAD`` 1e-3 of the one-process gradient;
- every parameter after the last step (and the master copy) within ``2
  * sum(lr)`` of theirs, half within ``0.005 * sum(lr)``, 99% within
  ``0.05 * sum(lr)``: the trainer tests' rule.

Exact, or all but: the processes' losses, norms and metrics agree to
the bit; every model rank holds the same bits of each leaf replicated
along ``model``; the first step's gradient with every bfloat16 rounding
of the models turned off (``float32_products``) is the one process's
within ``RTOL_FLOAT32`` 1e-4 of each leaf's largest value; the initial
blocks are the source weights to the bit (the master copy's the float32
source, not the rounded parameter). The collectives a step are a count
from the layer pattern (``chip_smoke.train_collectives``), no
``all_gather`` over ``model`` moves a weight, and the state's bytes are
the specs' arithmetic.
"""

import collections
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
from repro_torch.comm import shard_slices, spawn_ranks, spec_axes
from repro_torch.configs.base import get_smoke_config
from repro_torch.data import synthetic_tokens
from repro_torch.models import build
from repro_torch.models.attention import tp_layout
from repro_torch.models.convert import flatten, named_leaves, params_from_numpy
from repro_torch.models.layers import softmax_xent
from repro_torch.models.registry import meta_params
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import (build_train_step,
                                       make_state_shardings,
                                       partial_over_model)
import torch_train_dist_encdec_paths as epaths
import torch_train_dist_ssm_paths as spaths

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import model_gathers, train_collectives  # noqa: E402

GRID, AXES = (2, 2), ("data", "model")
STEPS, BATCH, SEQ, SEED = 3, 8, 32, 0
OPT = topt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
NO_EXCESS = {"xla_allow_excess_precision": False}
ATOL_LOSS = 2e-3
RTOL_GNORM = 5e-3
RTOL_GRAD, ATOL_GRAD = 0.03, 1e-3
RULE = np.array([2.0, 0.05, 0.005])
RTOL_FLOAT32 = 1e-4
TIMEOUT_S = 240
#: a case: its arch, ``tp_size`` (None: the config's own), whether it
#: keeps the master copy, its ``accum_steps``, and the case whose
#: references it is held to
Case = collections.namedtuple("Case", "arch tp master accum ref")
CASES = {"whisper": Case("whisper_small", None, False, 1, "whisper"),
         "whisper_heads": Case("whisper_small", 2, False, 1, "whisper"),
         "whisper_accum2": Case("whisper_small", None, False, 2,
                                "whisper_accum2"),
         "internvl2": Case("internvl2_1b", None, False, 1, "internvl2"),
         "tinyllama_master": Case("tinyllama_1_1b", None, True, 1,
                                  "tinyllama_master")}
#: the cases whose collectives a step the layer pattern counts (one
#: micro batch)
ONE_MICRO = [c for c in CASES if CASES[c].accum == 1]
LAYOUTS = {"whisper": "sequence", "whisper_heads": "heads",
           "internvl2": "sequence", "tinyllama_master": "sequence"}
REFERENCED = sorted({c.ref for c in CASES.values()})


def _bfloat16_tree(tree):
    return jax.tree.map(lambda a: np.asarray(
        jnp.asarray(a, jnp.bfloat16), np.float32), tree)


@pytest.fixture(scope="module")
def cases():
    """Each case's configs, weights (the JAX tree, the flat numpy leaves
    by port name; the master case's rounded to bfloat16) and batches."""
    out, weights = {}, {}
    for name, (arch, tp, master, accum, _) in CASES.items():
        cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
        if tp is not None:
            cfg = dataclasses.replace(cfg, tp_size=tp)
            jcfg = dataclasses.replace(jcfg, tp_size=tp)
        if arch not in weights:
            jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
            weights[arch] = (jparams, jax.tree.map(np.asarray, jparams))
        jparams, tree = weights[arch]
        if master:
            jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
            tree = _bfloat16_tree(tree)
        toks = synthetic_tokens(STEPS * BATCH * (SEQ + 1), cfg.vocab)
        batches = epaths.train_batches(
            np.random.default_rng(SEED),
            toks.reshape(STEPS, BATCH, SEQ + 1), cfg, GRID[0])
        out[name] = {"cfg": cfg, "jcfg": jcfg, "jparams": jparams,
                     "tree": tree, "flat": flatten(tree), "master": master,
                     "accum": accum, "unrounded": flatten(weights[arch][1]),
                     "batches": batches}
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in ("frames", "img_embeds")
                           else None) for k, v in b.items()}


# -- the references ---------------------------------------------------------


def _port_reference(c):
    """The port's one-process step: losses, norms, lrs, the first step's
    gradient (and under ``float32_products``), the parameters (and the
    master copy) after the last step."""
    cfg = c["cfg"]
    model = build(cfg)
    params = params_from_numpy(c["tree"], cfg, "cpu", dtype=torch.float32)
    out = {"losses": [], "grad_norms": [], "lrs": []}
    if not c["master"] and c["accum"] == 1:
        out["float32_grads"] = spaths.one_process_float32_grads(
            cfg, params, _torch_batch(c["batches"][0]))
    state = topt.init_opt_state(named_leaves(params, cfg), c["master"])
    if c["master"]:
        params.trainable(torch.bfloat16)

    def keep(g):
        out["grads"] = {n: None if t is None else t.detach().float().clone()
                        for n, t in g.items()}
    step = build_train_step(model, OPT, accum_steps=c["accum"])
    for i, b in enumerate(c["batches"]):
        _, _, m = step(params, state, _torch_batch(b),
                       on_grads=keep if i == 0 else None)
        for key, k in (("losses", "loss"), ("grad_norms", "grad_norm"),
                       ("lrs", "lr")):
            out[key].append(float(m[k]))
    out["params"] = {n: p.detach().float()
                     for n, p in params.named_parameters()}
    if c["master"]:
        out["master"] = dict(state["master"])
    return out


def _jax_unsharded(c):
    """The JAX package's step without a mesh (its master copy with
    bfloat16 parameters)."""
    jstep = jax_train_step(jax_build(c["jcfg"]), jopt.AdamWConfig(
        **dataclasses.asdict(OPT)), None, accum_steps=c["accum"])
    jp = c["jparams"]
    js = jopt.init_opt_state(jp, master=c["master"])
    fn = jax.jit(jstep).lower(jp, js, _jax_batch(c["batches"][0])).compile(
        NO_EXCESS)
    out = {"losses": [], "grad_norms": []}
    for b in c["batches"]:
        jp, js, m = fn(jp, js, _jax_batch(b))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))

    def flat32(tree):
        return {n: torch.from_numpy(np.asarray(v, np.float32))
                for n, v in flatten(jax.tree.map(np.asarray, tree)).items()}
    out["params"] = flat32(jp)
    if c["master"]:
        out["master"] = flat32(js["master"])
    return out


@pytest.fixture(scope="module")
def runs(cases):
    """The spawn (in a thread), the references meanwhile."""
    inputs = {name: {"cfg": c["cfg"], "master": c["master"],
                     "accum": c["accum"],
                     "batches": [_torch_batch(b) for b in c["batches"]],
                     "flat": {n: torch.from_numpy(np.array(v))
                              for n, v in c["flat"].items()}}
              for name, c in cases.items()}
    # the master copy's init from the unrounded float32 weights
    inputs["master_source"] = {
        "cfg": cases["tinyllama_master"]["cfg"],
        "flat": {n: torch.from_numpy(np.array(v)) for n, v in
                 cases["tinyllama_master"]["unrounded"].items()}}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(spawn_ranks, epaths.run_cases, GRID, AXES,
                          device="cpu", timeout_s=TIMEOUT_S,
                          args=(inputs, OPT))
        refs = {name: {"port": _port_reference(cases[name]),
                       "jax": _jax_unsharded(cases[name])}
                for name in REFERENCED}
        results = job.result()
    return results, time.perf_counter() - t0, refs


@pytest.fixture(scope="module")
def spawned(runs):
    return runs[0], runs[1]


@pytest.fixture(scope="module")
def references(runs):
    return {name: runs[2][c.ref] for name, c in CASES.items()}


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
    d = torch.cat([(got[n].float() - want[n].float()).abs().reshape(-1)
                   for n in want])
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
    """The trainer tests' rule over the parameters after the last step.
    Where the case keeps the float32 master copy the rule holds the
    master copy, and every bfloat16 parameter is its master's cast to
    the bit: one bfloat16 ulp of a weight near 0.1 is 0.14 ``sum(lr)``
    here, so the rule cannot hold the rounded parameters (the processes
    and the references differ by one ulp in 1-2% of them: the masters'
    float32 differences round apart)."""
    results, _ = spawned
    got = results[0][case]
    assert all(r[case]["params"] is None for r in results[1:])
    s = sum(references[case]["port"]["lrs"])
    key = "master" if CASES[case].master else "params"
    reading = _rule(got[key], references[case][ref][key], s)
    assert (reading <= RULE).all(), (key, reading)
    if CASES[case].master:
        for n, w in got["master"].items():
            assert torch.equal(got["params"][n], w.bfloat16()), n
            assert torch.equal(references[case][ref]["params"][n],
                               references[case][ref]["master"][n]
                               .bfloat16().float()), n


@pytest.mark.parametrize("case", list(CASES))
def test_processes_start_from_the_source_weights(spawned, cases, case):
    """The blocks ``init_train_state(..., ranks=)`` cuts, gathered, are
    the JAX package's weights to the bit (the master case's rounded to
    bfloat16, in bfloat16)."""
    results, _ = spawned
    got = results[0][case]["init_params"]
    want = cases[case]["flat"]
    assert set(got) == set(want)
    for n, w in want.items():
        assert got[n].dtype == (torch.bfloat16 if CASES[case].master
                                else torch.float32), n
        assert torch.equal(got[n].float(), torch.from_numpy(np.asarray(w))), n


def test_master_copy_is_cut_from_the_float32_source(spawned, cases):
    """``init_train_state(master=True, ranks=)`` from the unrounded
    weights: every parameter the source's block rounded to bfloat16, the
    master copy the source's float32 block by its ZeRO-1 spec (the
    moments' block shapes), gathered to the bit."""
    results, _ = spawned
    init = results[0]["master_init"]
    src = {n: torch.from_numpy(np.asarray(v))
           for n, v in cases["tinyllama_master"]["unrounded"].items()}
    assert init["dtypes"] == ["torch.bfloat16"]
    for n, w in src.items():
        assert torch.equal(init["master"][n], w), n
        assert torch.equal(init["params"][n], w.bfloat16()), n
    assert any(not torch.equal(w.bfloat16().float(), w) for w in src.values())
    for r in results:
        mi = r["master_init"]
        assert mi["master_shapes"] == mi["moment_shapes"]
        assert mi["master_shapes"] == r["tinyllama_master"]["master_shapes"]


# -- the masked loss ----------------------------------------------------------


def test_masked_loss_is_the_global_mean(spawned, references, cases):
    """Whisper's two data ranks hold different numbers of unmasked
    positions; every step's loss is the global masked mean (the one
    process's, within ``ATOL_LOSS``), not the mean of the two ranks'
    means, which lies farther from it than the bound at the first step."""
    results, _ = spawned
    c = cases["whisper"]
    cfg = c["cfg"]
    b0 = _torch_batch(c["batches"][0])
    half = BATCH // GRID[0]
    counts = [float(b0["loss_mask"][i * half:(i + 1) * half].sum())
              for i in range(GRID[0])]
    assert counts[0] != counts[1], counts
    params = params_from_numpy(c["tree"], cfg, "cpu", dtype=torch.float32)
    model = build(cfg)
    with torch.no_grad():
        whole = float(model.train_loss(params, b0)[0])
        means = [float(model.train_loss(params, {
            k: v[i * half:(i + 1) * half] for k, v in b0.items()})[0])
            for i in range(GRID[0])]
    got = results[0]["whisper"]["losses"]
    want = references["whisper"]["port"]["losses"]
    assert abs(whole - want[0]) <= 1e-6
    assert (np.abs(np.subtract(got, want)) <= ATOL_LOSS).all()
    assert abs(np.mean(means) - whole) > ATOL_LOSS, (means, whole)


def test_softmax_xent_count_divides_the_masked_sum():
    """``softmax_xent(..., count=)`` divides the masked sum by ``count``
    in place of ``max(sum(mask), 1)``: a data rank given the global count
    over the data ranks' number averages with the others to the global
    mean."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((4, 6, 10), generator=g)
    labels = torch.randint(0, 10, (4, 6), generator=g)
    mask = (torch.arange(6)[None] < torch.tensor([1, 2, 6, 5])[:, None])
    whole = softmax_xent(logits, labels, mask)
    total = torch.clamp(mask.float().sum(), min=1.0)
    parts = [softmax_xent(logits[i:i + 2], labels[i:i + 2], mask[i:i + 2],
                          count=total / 2) for i in (0, 2)]
    assert torch.allclose((parts[0] + parts[1]) / 2, whole, rtol=1e-6)
    none = softmax_xent(logits, labels, torch.zeros_like(mask))
    assert float(none) == 0.0


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


@pytest.mark.parametrize("case", [c for c in ONE_MICRO
                                  if not CASES[c].master])
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


@pytest.mark.parametrize("case", ["whisper", "whisper_heads", "internvl2"])
def test_partial_leaves_are_the_replicated_attentions(cases, case):
    """``partial_over_model`` marks every attention weight of the
    sequence layout, the enc-dec's encoder ``attn`` and decoder
    ``self_attn`` and ``cross_attn`` among them, and nothing else: the
    VLM's ``img_proj`` and the norms hold their whole gradient, and the
    heads layout shards every attention weight."""
    cfg = cases[case]["cfg"]
    specs = build(cfg).param_specs()
    got = {n for n, sp in specs.items() if partial_over_model(n, sp, cfg)}
    mats = ("wq", "wk", "wv", "wo")
    if case == "whisper_heads":
        want = set()
    elif case == "whisper":
        want = {f"enc_blocks.{i}.attn.{w}" for i in range(cfg.enc_layers)
                for w in mats} | {
            f"dec_blocks.{i}.{a}.{w}" for i in range(cfg.num_layers)
            for a in ("self_attn", "cross_attn") for w in mats}
    else:
        want = {f"blocks.{i}.attn.{w}" for i in range(cfg.num_layers)
                for w in mats}
    assert got == want


# -- collectives and state ----------------------------------------------------


def _layout(cfg):
    meta = meta_params(cfg)
    attn = meta.enc_blocks[0].attn if "enc_blocks" in meta else \
        meta.blocks[0].attn
    return tp_layout(cfg, attn, GRID[1])


@pytest.mark.parametrize("case", ONE_MICRO)
def test_collectives_a_step_equal_the_prediction(spawned, cases, case):
    """Every step's collectives equal the count from the layer pattern
    that ``chip_smoke.py`` phase 18 also holds the card's processes to
    (``train_collectives``), the mask's count included."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    assert _layout(cfg) == LAYOUTS[case]
    p, o = make_state_shardings(build(cfg), dict(zip(AXES, GRID)))
    partial = any(partial_over_model(n, sp, cfg) for n, sp in p.items())
    want = train_collectives(cfg, _layout(cfg), len(p), partial, GRID[0],
                             sum(o["m"][n] != p[n] for n in p),
                             masked="loss_mask" in cases[case]["batches"][0])
    for res in results:
        for counts in res[case]["counts"]:
            assert counts == want


@pytest.mark.parametrize("case", ONE_MICRO)
def test_no_weight_is_gathered_over_model(spawned, cases, case):
    """The ``all_gather``s over ``model`` move activations only
    (``chip_smoke.model_gathers``): the sequence layout's query rows,
    ``(B / data, S / model, d)`` bfloat16, twice an attention (forward
    and recompute): the encoder's frames, the decoder's tokens for the
    self- and the cross-attention, the VLM's image and text positions;
    none in the heads layout; every other runs over ``data``."""
    results, _ = spawned
    c = cases[case]
    cfg = c["cfg"]
    seq = SEQ + (cfg.img_tokens if cfg.family == "vlm" else 0)
    want = model_gathers(cfg, _layout(cfg), GRID, seq)
    assert len(want) == {"whisper": 12, "whisper_heads": 0, "internvl2": 4,
                         "tinyllama_master": 4}[case]
    for res in results:
        gathers = [e for e in res[case]["log"] if e["op"] == "all_gather"]
        over_model = [e["bytes"] for e in gathers if e["axes"] == ["model"]]
        assert sorted(over_model) == sorted(want)
        assert all(e["axes"] in (["model"], ["data"]) for e in gathers)


@pytest.mark.parametrize("case", list(CASES))
def test_state_bytes_are_the_specs(spawned, cases, case):
    """Each process holds its parameter blocks (float32, or bfloat16 with
    the master copy), its ZeRO-1 moment blocks and its master copy's
    (float32), and nothing more."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    master = CASES[case].master
    shapes = _shapes(cfg)
    sizes = dict(zip(AXES, GRID))
    p, o = make_state_shardings(build(cfg), sizes, master=master)

    def nbytes(specs, width=4):
        return sum(width * math.prod(shapes[n]) // math.prod(
            sizes[a] for a in spec_axes(specs[n])) for n in shapes)
    for res in results:
        assert res[case]["param_bytes"] == nbytes(p, 2 if master else 4)
        assert res[case]["moment_bytes"] == 2 * nbytes(o["m"])
        if master:
            assert res[case]["master_bytes"] == nbytes(o["master"])
            assert res[case]["master_shapes"] == res[case]["moment_shapes"]


# -- what builds -----------------------------------------------------------------


def test_published_configs_build_on_process_ranks(spawned):
    """Whisper-small and InternVL2-1B at their published configs build on
    ``(2, 2)`` (the 4 processes) and on ``(2, 4)`` (a fake process group
    of 8: nothing runs); on ``(1, 8)`` Whisper's 1500 frames do not split
    over 8 model ranks of the sequence layout."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.comm import ProcessRanks
    results, _ = spawned
    for r in results:
        assert r["published"] == {"whisper_small": "", "internvl2_1b": ""}
    dist.init_process_group("fake", store=FakeStore(), world_size=8, rank=0)
    try:
        got = {shape: epaths.published_build_errors(
            ProcessRanks(shape, AXES, device="cpu"))
            for shape in ((2, 4), (1, 8))}
    finally:
        dist.destroy_process_group()
    assert got[(2, 4)] == {"whisper_small": "", "internvl2_1b": ""}
    assert got[(1, 8)]["internvl2_1b"] == ""
    assert "1500 encoder frames do not split over 8 model ranks" in \
        got[(1, 8)]["whisper_small"]


def test_spawn_is_inside_its_limit(spawned):
    _, seconds = spawned
    assert seconds < TIMEOUT_S
