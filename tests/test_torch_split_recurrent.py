"""xLSTM's recurrent heads and Whisper's sequence blocks over ``model``
ranks that do not divide them, trained and served over 4 gloo CPU
processes on ``(1, 4)``, against the JAX package on one CPU device and
against the port's one process.

The layouts:

- mLSTM heads split over ranks (``ssm.tp_heads``, ``ssm.mlstm_share``):
  fewer heads than model ranks, dividing them; each head spans ``model /
  H`` ranks, each of which receives its head's whole ``q``, ``k`` and
  gates and its own channels of ``v`` in the one ``scatter_sum``, and
  runs its rows of ``C``; the caches keep the heads whole and are
  written after one ``all_gather``. sLSTM runs whole on every rank;
- the sequence layout's uneven blocks (``attention.seq_rows``,
  ``gather_rows``): ``ceil(S / model)`` rows a rank, the last shorter,
  padded for the gather and trimmed.

The cases, smoke size, weights the JAX package's ``init`` at
``PRNGKey(0)`` carried across by ``convert``:

- ``xlstm``: smoke xLSTM (2 mLSTM layers and 1 sLSTM layer of 2 heads,
  ``d_in`` 128) on ``(1, 4)``: half an mLSTM head a rank (32 of its 64
  ``v`` channels), trained one step on 8 x 32 tokens and served (a
  prompt of 16, 6 decode steps teacher-forced);
- ``whisper``: smoke Whisper with ``tp_size`` 8, so that its 4 heads
  take the sequence layout, and ``enc_seq`` 30 on ``(1, 4)``: the
  encoder's rows 8, 8, 8 and 6 a rank; trained on 8 x 30 tokens with a
  loss mask and served with a prompt of 14 (4, 4, 4 and 2 rows a rank).

One spawn runs both (``tests/torch_split_recurrent_paths.py``, no JAX)
in a thread while this process computes the references.

Bounds, ``tests/test_torch_split_heads.py``'s: the loss within
``ATOL_LOSS`` 2e-3, ``grad_norm`` within ``RTOL_GNORM`` 5e-3 relative,
each leaf's gradient within ``RTOL_GRAD`` 3% of its largest value plus
``ATOL_GRAD`` 1e-3 of the port's; the logits within ``ATOL_PORT``
0.0625 of the port and ``ATOL_JAX`` 0.25 of the JAX package; the
caches' states and written slots within ``ATOL_CACHE_PORT`` 0.0625 and
``ATOL_CACHE_JAX`` 0.125. Against the JAX package each leaf's gradient
within ``RTOL_GRAD_JAX`` 8%: the port's one process reads 3.7% of the
largest value of xLSTM's ``blocks.0.cell.conv_b`` from it (its
bfloat16 products summed in another order), the processes 4.0%.
Measured: the losses within 2.2e-4, ``grad_norm`` 4e-5 to 3.2e-4
relative, the gradients 0.6-1.0% against the port, the logits 0.016 to
0.031, the caches 0 to 0.034 (sLSTM's stabilizer ``m``, 82 at most).

Exact: each step's and decode step's collectives against
``chip_smoke``'s counts from the layer pattern and the bytes of every
``all_gather`` over ``model`` (``chip_smoke.model_gathers``); every
cache leaf's block shape against its spec and Whisper's ``pos``; the
rows of the uneven gather and the zero gradient of its padding rows.
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
from repro.models import encdec as jax_encdec
from repro_torch.comm import shard_slices, spawn_ranks
from repro_torch.configs.base import get_smoke_config
from repro_torch.data import synthetic_tokens
from repro_torch.models import build
from repro_torch.models.attention import seq_rows, tp_layout
from repro_torch.models.convert import flatten, params_from_numpy
from repro_torch.models.registry import meta_params
from repro_torch.models.ssm import mlstm_share, tp_heads
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import loss_and_grads, partial_over_model
import torch_serve_dist_paths as spaths
import torch_split_recurrent_paths as rpaths
from torch_train_dist_encdec_paths import train_batches

from test_torch_split_heads import _as_torch, _assembled_grads, _norm

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import (model_gathers, serve_collectives,  # noqa: E402
                        serve_layout, train_collectives)

AXES = ("data", "model")
GRID = (1, 4)
BATCH, STEPS, MAX_LEN = 8, 6, 48
OPT = topt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
NO_EXCESS = {"xla_allow_excess_precision": False}
ATOL_LOSS, RTOL_GNORM = 2e-3, 5e-3
RTOL_GRAD, ATOL_GRAD = 0.03, 1e-3
RTOL_GRAD_JAX = 0.08
ATOL_PORT, ATOL_JAX = 0.0625, 0.25
ATOL_CACHE_PORT, ATOL_CACHE_JAX = 0.0625, 0.125
TIMEOUT_S = 150
#: case: (arch, replaced config fields, training length, prompt)
CASES = {
    "xlstm": ("xlstm_125m", {}, 32, 16),
    "whisper": ("whisper_small", {"tp_size": 8, "enc_seq": 30}, 30, 14),
}


def _bfloat16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def _serve_inputs(cfg, prompt: int, seed: int) -> dict:
    """A prompt of uniform tokens a row (Whisper's frames normal, rounded
    to bfloat16) and ``STEPS`` decode steps teacher-forced on uniform
    tokens from position ``prompt``."""
    rng = np.random.default_rng(seed)
    pre = {"tokens": rng.integers(0, cfg.vocab, (BATCH, prompt))
           .astype(np.int32)}
    if cfg.family == "audio":
        pre["frames"] = _bfloat16(rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)))
    return {"prefill": pre,
            "steps": [{"tokens": rng.integers(0, cfg.vocab, (BATCH, 1))
                       .astype(np.int32),
                       "pos": np.full((BATCH, 1), prompt + t, np.int32)}
                      for t in range(STEPS)]}


def _torch_inputs(serve: dict) -> dict:
    out = _as_torch(serve)
    if "frames" in out["prefill"]:
        out["prefill"]["frames"] = out["prefill"]["frames"].bfloat16()
    return dict(out, max_len=MAX_LEN)


@pytest.fixture(scope="module")
def cases():
    out = {}
    for i, (name, (arch, replace, seq, prompt)) in enumerate(CASES.items()):
        cfg = dataclasses.replace(get_smoke_config(arch), **replace)
        jcfg = dataclasses.replace(jax_smoke_config(arch), **replace)
        jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        toks = synthetic_tokens(BATCH * (seq + 1), cfg.vocab).reshape(
            1, BATCH, seq + 1)
        batch = train_batches(np.random.default_rng(i), toks, cfg, 1)[0]
        serve = _serve_inputs(cfg, prompt, seed=i)
        out[name] = {"cfg": cfg, "jcfg": jcfg, "jparams": jparams,
                     "tree": tree, "seq": seq, "prompt": prompt,
                     "batch": batch, "serve": serve,
                     "flat": {n: torch.from_numpy(np.array(v))
                              for n, v in flatten(tree).items()},
                     "inputs": _torch_inputs(serve)}
    return out


# -- the references ---------------------------------------------------------


def _port_reference(c) -> dict:
    """The port's one process: the batch's loss and gradient, then the
    prefill and the decode steps."""
    cfg = c["cfg"]
    model = build(cfg)
    params = params_from_numpy(c["tree"], cfg, "cpu", dtype=torch.float32)
    loss, _, g = loss_and_grads(model, params, _as_torch(c["batch"]), None)
    serve = spaths.serve(model, params_from_numpy(c["tree"], cfg, "cpu"),
                         c["inputs"], model.init_caches(BATCH, MAX_LEN,
                                                        "cpu"))
    return {"loss": float(loss), "grad_norm": _norm(g),
            "grads": {n: t.detach() for n, t in g.items()},
            "logits": serve["logits"], "caches": _layers(serve["caches"])}


def _jax_caches(caches) -> list:
    return [{k: torch.from_numpy(np.asarray(
                v, np.int32 if k == "pos" else np.float32))
             for k, v in layer.items()} for layer in _layers(caches)]


def _jax_reference(c) -> dict:
    """The JAX package on one CPU device: ``value_and_grad`` of
    ``train_loss`` on the batch, the prefill and each decode step (the
    enc-dec's carrying its encoder output)."""
    cfg, model, p = c["jcfg"], jax_build(c["jcfg"]), c["jparams"]

    def compiled(fn, *args):
        return jax.jit(fn).lower(*args).compile(NO_EXCESS)
    b0 = {k: jnp.asarray(v) for k, v in c["batch"].items()}
    f = jax.value_and_grad(lambda q, b: model.train_loss(q, b)[0])
    loss, g = compiled(f, p, b0)(p, b0)
    grads = {n: torch.from_numpy(np.asarray(v, np.float32))
             for n, v in flatten(jax.tree.map(np.asarray, g)).items()}
    caches = model.init_caches(BATCH, MAX_LEN)
    pre = {k: jnp.asarray(v, jnp.bfloat16 if k == "frames" else None)
           for k, v in c["serve"]["prefill"].items()}
    lg, caches = compiled(model.prefill, p, pre, caches)(p, pre, caches)
    logits, step = [np.asarray(lg, np.float32)], None
    enc_out = None
    if cfg.family == "audio":
        enc_out = compiled(lambda q, fr: jax_encdec.encode(q, cfg, fr),
                           p, pre["frames"])(p, pre["frames"])
    for s in c["serve"]["steps"]:
        b = {k: jnp.asarray(v) for k, v in s.items()}
        if enc_out is not None:
            b["enc_out"] = enc_out
        if step is None:
            step = compiled(model.decode_step, p, caches, b)
        lg, caches = step(p, caches, b)
        logits.append(np.asarray(lg, np.float32))
    return {"loss": float(loss), "grad_norm": _norm(grads), "grads": grads,
            "logits": [torch.from_numpy(a) for a in logits],
            "caches": _jax_caches(caches)}


@pytest.fixture(scope="module")
def runs(cases):
    """The spawn, in a thread, started first; the references meanwhile."""
    group = {name: {"cfg": c["cfg"], "flat": c["flat"],
                    "inputs": c["inputs"],
                    "batches": [_as_torch(c["batch"])]}
             for name, c in cases.items()}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(spawn_ranks, rpaths.run_cases, GRID, AXES,
                          device="cpu", timeout_s=TIMEOUT_S,
                          args=(group, OPT))
        refs = {name: {"port": _port_reference(c), "jax": _jax_reference(c)}
                for name, c in cases.items()}
        results = job.result()
    return results, time.perf_counter() - t0, refs


@pytest.fixture(scope="module")
def spawned(runs):
    return runs[0]


@pytest.fixture(scope="module")
def references(runs):
    return runs[2]


def _layers(caches) -> list:
    return caches if isinstance(caches, list) else [caches]


# -- the layouts ------------------------------------------------------------


@pytest.mark.parametrize("case,layout", [("xlstm", None),
                                         ("whisper", "sequence")])
def test_cases_take_the_layouts(cases, case, layout):
    """Smoke xLSTM's 2 mLSTM heads span 2 of the 4 ranks each and its
    sLSTM runs whole; smoke Whisper's 4 heads against ``tp_size`` 8 take
    the sequence layout, its 30 frames and 30 or 14 tokens in uneven
    blocks."""
    cfg = cases[case]["cfg"]
    assert serve_layout(cfg, GRID[1]) == layout
    if case == "xlstm":
        assert (tp_heads(cfg, "mlstm", 4), mlstm_share(cfg, 4)) == (1, 2)
        assert tp_heads(cfg, "slstm", 4) == 2
    else:
        attn = meta_params(cfg).enc_blocks[0].attn
        assert tp_layout(cfg, attn, 4) == "sequence"
        for S in (cfg.enc_seq, cases[case]["seq"], cases[case]["prompt"]):
            assert S % GRID[1]
            blocks = [seq_rows(S, 4, r) for r in range(4)]
            assert [b.start for b in blocks[1:]] == [
                b.stop for b in blocks[:-1]]
            assert (blocks[0].start, blocks[-1].stop) == (0, S)


# -- the training step ------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_training_step_matches_the_references(spawned, references, cases,
                                              case, ref):
    """The step's loss, ``grad_norm`` and every leaf's gradient,
    assembled from the processes' blocks."""
    results = [r[case] for r in spawned]
    want = references[case][ref]
    mine = [r["train"] for r in results]
    assert all(m["losses"] == mine[0]["losses"] for m in mine)
    assert abs(mine[0]["losses"][0] - want["loss"]) <= ATOL_LOSS
    assert abs(mine[0]["grad_norms"][0] - want["grad_norm"]) <= \
        RTOL_GNORM * want["grad_norm"]
    got = _assembled_grads(results, cases[case]["cfg"], GRID)
    assert set(got) == set(want["grads"])
    rtol = RTOL_GRAD if ref == "port" else RTOL_GRAD_JAX
    for n, w in want["grads"].items():
        err = float((got[n] - w).abs().max())
        assert err <= rtol * float(w.abs().max()) + ATOL_GRAD, (n, err)


@pytest.mark.parametrize("case", list(CASES))
def test_training_collectives_equal_the_prediction(spawned, cases, case):
    """The step's collectives equal ``chip_smoke.train_collectives``'
    count (the split heads' ``scatter_sum`` the same one a layer as the
    heads layout's; the uneven blocks one ``all_gather`` each), and the
    bytes of every ``all_gather`` over ``model`` are
    ``chip_smoke.model_gathers``' (mLSTM's gradient block of 2 x 64 + 32
    + 2 columns; Whisper's blocks padded to 8 rows)."""
    c = cases[case]
    cfg = c["cfg"]
    layout = serve_layout(cfg, GRID[1])
    t = spawned[0][case]["train"]
    p_specs = t["param_specs"]
    partial = any(partial_over_model(n, sp, cfg) for n, sp in p_specs.items())
    want = train_collectives(cfg, layout, len(p_specs), partial, GRID[0],
                             masked=cfg.family == "audio")
    gathers = model_gathers(cfg, layout, GRID, c["seq"])
    assert gathers
    for r in spawned:
        assert r[case]["train"]["counts"] == [want]
        got = [e["bytes"] for e in r[case]["train"]["log"]
               if e["op"] == "all_gather" and e["axes"] == ["model"]]
        assert sorted(got) == sorted(gathers)


# -- serving ----------------------------------------------------------------


def _logits(spawned, case, i):
    """Call ``i``'s logits: every model rank holds the same bits."""
    got = [r[case]["serve"]["logits"][i] for r in spawned]
    assert all(torch.equal(g, got[0]) for g in got), i
    return got[0]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_logits_match_the_references(spawned, references, cases, case,
                                     ref):
    """The prefill's next-token logits and each decode step's, every
    row's, over the real vocabulary, finite."""
    v = cases[case]["cfg"].vocab
    want = references[case][ref]["logits"]
    bound = ATOL_PORT if ref == "port" else ATOL_JAX
    assert len(want) == STEPS + 1
    for i in range(STEPS + 1):
        got = _logits(spawned, case, i)
        assert got.shape == want[i].shape
        assert torch.isfinite(got).all(), i
        err = float((got[..., :v].float() - want[i][..., :v]).abs().max())
        assert err <= bound, (i, err)


def _assembled_caches(spawned, case, cfg, want) -> list:
    """Every cache leaf of every layer assembled from the processes'
    blocks by the specs, after checking each block's shape against its
    spec and that every block the specs replicate holds the same bits on
    every rank."""
    specs = _layers(build(cfg).batch_cache_specs(BATCH, ("data",)))
    out = []
    for i, layer in enumerate(want):
        got = {}
        for k, w in layer.items():
            full = (torch.full(w.shape, -2, dtype=torch.int32) if k == "pos"
                    else torch.full(w.shape, float("nan")))
            for r, res in enumerate(spawned):
                sl = shard_slices(w.shape, specs[i][k], GRID, AXES, r)
                block = _layers(res[case]["serve"]["caches"])[i][k]
                assert tuple(block.shape) == tuple(full[sl].shape), (i, k)
                block = block.to(full.dtype)
                seen = full[sl]
                filled = seen != -2 if k == "pos" else ~torch.isnan(seen)
                assert torch.equal(seen[filled], block[filled]), (i, k, r)
                full[sl] = block
            got[k] = full
        out.append(got)
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_caches_match_the_references(spawned, references, cases, case,
                                     ref):
    """The caches after the last step: xLSTM's states (``C``, ``n``,
    ``m``, ``conv``; sLSTM's ``c``, ``n``, ``h``, ``m``) every rank's
    rows written, Whisper's ``pos`` exactly and every written slot's keys
    and values within the bound, every empty slot zero."""
    cfg = cases[case]["cfg"]
    want = references[case][ref]["caches"]
    got = _assembled_caches(spawned, case, cfg, want)
    bound = ATOL_CACHE_PORT if ref == "port" else ATOL_CACHE_JAX
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        if "pos" in w:
            assert torch.equal(g["pos"], w["pos"].to(torch.int32))
            written = w["pos"] >= 0
        for k in set(w) - {"pos"}:
            assert not torch.isnan(g[k]).any(), (i, k)
            err = (g[k] - w[k].float()).abs()
            if "pos" in w:
                shape = written.shape + (1,) * (err.dim() - written.dim())
                assert not (g[k] * ~written.reshape(shape)).any(), k
                err = err * written.reshape(shape)
            assert float(err.max()) <= bound, (i, k)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_collectives_equal_the_prediction(spawned, cases, case):
    """Each decode step's collectives equal ``chip_smoke``'s
    ``serve_collectives`` (an mLSTM layer's state gather into the cache
    that keeps its heads whole; the sequence layout's one position
    attended whole, no gather)."""
    cfg = cases[case]["cfg"]
    want = serve_collectives(cfg, serve_layout(cfg, GRID[1]), GRID[0])
    for r in spawned:
        counts = r[case]["serve"]["counts"]
        assert len(counts) == STEPS
        assert all(cnt == want for cnt in counts)


# -- the uneven gather ------------------------------------------------------


@pytest.mark.parametrize("S,d", rpaths.GATHERS)
def test_uneven_rows_gather_whole_and_padding_takes_no_gradient(spawned,
                                                                 S, d):
    """Each rank's rows (``seq_rows``: 8, 8, 8, 6 of 30; 2, 2, 1, 0 of 5)
    join into the whole; a rank's rows take their own gradient, and its
    padded block's padding rows a zero one."""
    gen = torch.Generator().manual_seed(S)
    whole = torch.randn((2, S, d), generator=gen)
    weight = torch.randn((2, S, d), generator=gen)
    c = math.ceil(S / GRID[1])
    for r, res in enumerate(spawned):
        g = res["gathers"][S]
        lo, hi = g["rows"]
        assert (lo, hi) == (min(r * c, S), min((r + 1) * c, S))
        assert torch.equal(g["joined"], whole)
        assert torch.equal(g["x_grad"], weight[:, lo:hi])
        assert g["padded_grad"].shape == (2, c, d)
        assert torch.equal(g["padded_grad"][:, :hi - lo], weight[:, lo:hi])
        assert not g["padded_grad"][:, hi - lo:].any()
    assert spawned[-1]["gathers"][S]["rows"][1] - \
        spawned[-1]["gathers"][S]["rows"][0] < c


def test_spawn_is_inside_its_limit(runs):
    assert runs[1] < TIMEOUT_S
