"""Attention whose heads split over ``model`` ranks, trained and served
over gloo CPU processes, against the JAX package on one CPU device and
against the port's one process.

The two layouts (``repro_torch.models.attention.tp_layout``):

- ``split_kv``: ``wk``/``wv`` column-split with ``1 < KV < model``, so
  that a rank holds part of one KV head's dimensions; the new keys and
  values are gathered whole (``comm.gather_heads``: ``all_gather``
  forward, ``reduce_scatter`` backward) before ``k_norm`` and rope, and
  the rank's query heads attend the one KV head they use;
- ``split_heads``: MLA heads that ``model`` does not divide; an
  ``exchange`` after each of ``wq_up``'s, ``wk_up``'s and ``wv_up``'s
  column-parallel products moves the pieces of each head to its owner,
  the inverse one before ``wo``.

The cases, smoke size, each a training step and a prefill with decode
steps; weights the JAX package's ``init`` at ``PRNGKey(0)``, carried
across by ``convert``:

- ``tinyllama`` (a): ``tp_size=4`` on ``(1, 4)``: 2 KV heads of ``hd`` 8
  over 4 ranks, half a head a rank;
- ``qwen3_moe`` (b): ``tp_size=4`` and 16 experts on ``(1, 4)``: q/k
  norms, one query head a rank, the experts through the sphere dispatch
  (K1's plain version) in training and the prefill. Its capacity factor
  16 drops no expert choice: the JAX package's one-device dispatch and
  the grid's count capacity over other groups of tokens, which only a
  drop would show;
- ``danube`` (c): H2O-Danube, ``tp_size=4`` on ``(2, 4)`` as 8
  processes, trained on 8 rows and served at a batch of one (the form of
  ``long_500k``: its row replicated over ``data``, the sliding-window
  ring of 16 slots not time-sharded), decoding past its window;
- ``mla_split`` (d): MiniCPM3 with 10 heads on ``(1, 4)``, 2.5 heads a
  rank, ``qk_nope_dim`` 16 against ``qk_rope_dim`` 8: ``wq_up``'s block
  ends 12 of 24 columns into head 2 (inside its nope part, as 48 of 96
  does at 40 heads over 16), ``wk_up``'s 8 of 16, ``wv_up``'s 4 of 8.

Two spawns (4 and 8 processes, ``tests/torch_split_heads_paths.py``, no
JAX) run in threads while this process computes the references.

The references. The JAX package on one CPU device (XLA's excess precision
off): ``value_and_grad`` of ``train_loss`` on the first batch,
``prefill`` and ``decode_step``. The port's one process; for the MoE its
stacked ``Ranks`` on the same grid, whose dispatch, as the processes',
frames the routed experts' inputs as bytes: the routed experts take no
gradient and neither does anything upstream through them, so the MoE's
training step is held to the JAX package by its loss alone. The MoE's
serving is held to the JAX package on a ``(1, 4)`` mesh of 4 virtual
CPU devices (``tests/test_torch_serve_dist.py``'s subprocess): its
prefill dispatches through the sphere shuffle, as the processes' does,
with the routing probabilities carried in bfloat16, where one device
dispatches densely; the two read 0.8 apart on the prefill's logits of
this case (the port's one-device dense dispatch reads 0.016 from the
JAX package's).

Bounds, the process-rank tests': the loss within ``ATOL_LOSS`` 2e-3,
``grad_norm`` within ``RTOL_GNORM`` 5e-3 relative, each leaf's gradient
within ``RTOL_GRAD`` 3% of its largest value plus ``ATOL_GRAD`` 1e-3
(``tests/test_torch_train_dist_families.py``); the logits within
``ATOL_PORT`` 0.0625 of the port and ``ATOL_JAX`` 0.25 of the JAX
package, the caches' written slots within ``ATOL_CACHE_PORT`` 0.0625 and
``ATOL_CACHE_JAX`` 0.125 (``tests/test_torch_serve_dist.py``); a MoE's
calls up to its first decode step that routes otherwise. Measured: the
losses within 1.1e-5 (the MoE against the JAX package 5.8e-4: its
``moe_aux`` is the mean of each model rank's block of positions'),
``grad_norm`` 3e-5 to 4e-4 relative, the gradients 1.0-1.8% of each
leaf's largest value, the logits 0 to 0.008 (the MoE against the JAX
mesh 0.040, which routes its last decode step otherwise).

Exact: the collectives of the step and of each decode step against
``chip_smoke``'s counts from the layer pattern; the ``all_gather``s over
``model`` are activations' (``chip_smoke.model_gathers``); K1's calls;
every cache's ``pos``; the bits every rank holds of a block the specs
replicate. Besides: the piece table and the KV head a rank uses against
brute-force maps, and the shapes that still raise.
"""

import concurrent.futures
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build as jax_build
from repro_torch.comm import Ranks, shard_slices, spawn_ranks, spec_axes
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data import synthetic_tokens
from repro_torch.models import build
from repro_torch.models.attention import (kv_head_of_rank, mla_owned_heads,
                                          mla_pieces, tp_layout)
from repro_torch.models.convert import flatten, params_from_numpy
from repro_torch.models.registry import meta_params
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import (check_grid_layout, loss_and_grads,
                                       partial_over_model)
import torch_serve_dist_paths as spaths
import torch_split_heads_paths as hpaths

from test_torch_jax_refs import SRC
from test_torch_serve_dist import _JAX_CODE, _jax_results

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import (model_gathers, serve_collectives,  # noqa: E402
                        serve_layout, train_collectives)

AXES = ("data", "model")
BATCH, SEQ = 8, 32
PROMPT, MAX_LEN, STEPS = 16, 48, 8
OPT = topt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
NO_EXCESS = {"xla_allow_excess_precision": False}
ATOL_LOSS, RTOL_GNORM = 2e-3, 5e-3
RTOL_GRAD, ATOL_GRAD = 0.03, 1e-3
ATOL_PORT, ATOL_JAX = 0.0625, 0.25
ATOL_CACHE_PORT, ATOL_CACHE_JAX = 0.0625, 0.125
TIMEOUT_S = 150
#: case: (arch, replaced config fields, grid, the served batch, layout)
CASES = {
    "tinyllama": ("tinyllama_1_1b", {"tp_size": 4}, (1, 4), BATCH,
                  "split_kv"),
    "qwen3_moe": ("qwen3_moe_30b_a3b", {"tp_size": 4, "num_experts": 16,
                                        "capacity_factor": 16.0},
                  (1, 4), BATCH, "split_kv"),
    "danube": ("h2o_danube_1_8b", {"tp_size": 4}, (2, 4), 1, "split_kv"),
    "mla_split": ("minicpm3_4b", {"d_model": 80, "n_heads": 10,
                                  "n_kv_heads": 10, "qk_nope_dim": 16,
                                  "qk_rope_dim": 8, "v_head_dim": 8},
                  (1, 4), BATCH, "split_heads"),
}
MOE = ("qwen3_moe",)
ROUTED = ("w_gate", "w_up", "w_down")


def _serve_inputs(cfg, rows: int, seed: int) -> dict:
    """A prompt of ``PROMPT`` uniform tokens a row and ``STEPS`` decode
    steps teacher-forced on uniform tokens from position ``PROMPT``."""
    rng = np.random.default_rng(seed)
    return {"prefill": {"tokens": rng.integers(
                0, cfg.vocab, (rows, PROMPT)).astype(np.int32)},
            "steps": [{"tokens": rng.integers(0, cfg.vocab, (rows, 1))
                       .astype(np.int32),
                       "pos": np.full((rows, 1), PROMPT + t, np.int32)}
                      for t in range(STEPS)]}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def cases():
    out = {}
    for i, (name, (arch, replace, grid, rows, _)) in enumerate(
            CASES.items()):
        cfg = dataclasses.replace(get_smoke_config(arch), **replace)
        jcfg = dataclasses.replace(jax_smoke_config(arch), **replace)
        jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        toks = synthetic_tokens(BATCH * (SEQ + 1), cfg.vocab).reshape(
            BATCH, SEQ + 1)
        batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
        serve = _serve_inputs(cfg, rows, seed=i)
        out[name] = {"cfg": cfg, "jcfg": jcfg, "jparams": jparams,
                     "tree": tree, "grid": grid, "rows": rows,
                     "batch": batch, "serve": serve,
                     "flat": {n: torch.from_numpy(np.array(v))
                              for n, v in flatten(tree).items()},
                     "inputs": dict(_as_torch(serve), max_len=MAX_LEN)}
    return out


# -- the references ---------------------------------------------------------


def _stacked(c):
    """The MoE's stacked ``Ranks`` on its grid, else None."""
    return (Ranks(shape=c["grid"], axes=AXES, device="cpu")
            if c["cfg"].family == "moe" else None)


def _norm(grads) -> float:
    return math.sqrt(sum(float((g.double() ** 2).sum())
                         for g in grads.values() if g is not None))


def _port_reference(c) -> dict:
    """The port's one process (the MoE's stacked ``Ranks``): the first
    batch's loss and gradient, then the prefill and the decode steps."""
    cfg = c["cfg"]
    model = build(cfg)
    rk = _stacked(c)
    params = params_from_numpy(c["tree"], cfg, "cpu", dtype=torch.float32)
    loss, _, g = loss_and_grads(model, params, _as_torch(c["batch"]), rk)
    serve = spaths.serve(model, params_from_numpy(c["tree"], cfg, "cpu"),
                         c["inputs"], model.init_caches(c["rows"], MAX_LEN,
                                                        "cpu"), rk)
    return {"loss": float(loss), "grad_norm": _norm(g),
            "grads": {n: None if t is None else t.detach()
                      for n, t in g.items()},
            "logits": serve["logits"], "routes": serve["routes"],
            "caches": serve["caches"]}


def _jax_reference(c) -> dict:
    """The JAX package on one CPU device: ``value_and_grad`` of
    ``train_loss`` on the first batch, the prefill and each decode step
    (not for a MoE: :func:`_start_jax_mesh` serves it)."""
    model = jax_build(c["jcfg"])
    p = c["jparams"]

    def compiled(fn, *args):
        return jax.jit(fn).lower(*args).compile(NO_EXCESS)
    b0 = {k: jnp.asarray(v) for k, v in c["batch"].items()}
    f = jax.value_and_grad(lambda q, b: model.train_loss(q, b)[0])
    loss, g = compiled(f, p, b0)(p, b0)
    grads = {n: torch.from_numpy(np.asarray(v, np.float32))
             for n, v in flatten(jax.tree.map(np.asarray, g)).items()}
    out = {"loss": float(loss), "grad_norm": _norm(grads), "grads": grads}
    if c["cfg"].family == "moe":
        return out
    caches = model.init_caches(c["rows"], MAX_LEN)
    pre = {k: jnp.asarray(v) for k, v in c["serve"]["prefill"].items()}
    lg, caches = compiled(model.prefill, p, pre, caches)(p, pre, caches)
    logits, step = [np.asarray(lg, np.float32)], None
    for s in c["serve"]["steps"]:
        b = {k: jnp.asarray(v) for k, v in s.items()}
        if step is None:
            step = compiled(model.decode_step, p, caches, b)
        lg, caches = step(p, caches, b)
        logits.append(np.asarray(lg, np.float32))
    out.update(logits=[torch.from_numpy(a) for a in logits],
               caches={k: torch.from_numpy(np.asarray(
                   v, np.int32 if k == "pos" else np.float32))
                   for k, v in caches.items()})
    return out


def _start_jax_mesh(cases, d, err):
    """The JAX package's prefill and decode steps of the MoE cases on
    their ``(1, 4)`` mesh of 4 virtual CPU devices, in a subprocess
    (started here, waited for later; its standard error to ``err``)."""
    grid = cases[MOE[0]]["grid"]
    assert all(cases[n]["grid"] == grid for n in MOE)
    arrays = {f"{n}.prefill.{k}": v for n in MOE
              for k, v in cases[n]["serve"]["prefill"].items()}
    for n in MOE:
        for t, step in enumerate(cases[n]["serve"]["steps"]):
            arrays.update({f"{n}.step{t}.{k}": v for k, v in step.items()})
    np.savez(d / "inputs.npz", **arrays)
    spec = {"grid": grid, "axes": AXES, "steps": STEPS,
            "inputs": str(d / "inputs.npz"), "out": str(d / "out.npz"),
            "cases": {n: [CASES[n][0], CASES[n][1], cases[n]["rows"],
                          MAX_LEN] for n in MOE}}
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_allow_excess_precision=false")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_CODE), json.dumps(spec)],
        env=env, stdout=subprocess.DEVNULL, stderr=err)


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """The two spawns (one a grid, in threads), started first; the
    references meanwhile."""
    by_grid = {}
    for name, c in cases.items():
        by_grid.setdefault(c["grid"], {})[name] = {
            "cfg": c["cfg"], "flat": c["flat"], "inputs": c["inputs"],
            "batches": [_as_torch(c["batch"])]}
    d = tmp_path_factory.mktemp("split_heads")
    t0 = time.perf_counter()
    with open(d / "stderr.txt", "w") as err:
        proc = _start_jax_mesh(cases, d, err)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(by_grid)) as pool:
            jobs = {grid: pool.submit(spawn_ranks, hpaths.run_cases, grid,
                                      AXES, device="cpu",
                                      timeout_s=TIMEOUT_S, args=(group, OPT))
                    for grid, group in by_grid.items()}
            refs = {name: {"port": _port_reference(c),
                           "jax": _jax_reference(c)}
                    for name, c in cases.items()}
            results = {}
            for grid, job in jobs.items():
                per_rank = job.result()
                for name in by_grid[grid]:
                    results[name] = [r[name] for r in per_rank]
        seconds = time.perf_counter() - t0
        proc.wait(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, (d / "stderr.txt").read_text()
    for name, r in _jax_results(dict(np.load(d / "out.npz")), MOE).items():
        refs[name]["jax"].update(logits=r["logits"], routes=r["routes"],
                                 caches=r["caches"])
    return results, seconds, refs


@pytest.fixture(scope="module")
def spawned(runs):
    return runs[0], runs[1]


@pytest.fixture(scope="module")
def references(runs):
    return runs[2]


def _assembled_grads(results, cfg, grid):
    """The first step's reduced gradient of every leaf, assembled from
    the processes' blocks."""
    shapes = {n: tuple(p.shape) for n, p in
              meta_params(cfg).named_parameters()}
    out = {}
    for n, shape in shapes.items():
        full = torch.empty(shape)
        for r, res in enumerate(results):
            t = res["train"]
            full[shard_slices(shape, t["grad_specs"][n], grid, AXES, r)] = \
                t["grads"][n]
        out[n] = full
    return out


# -- the training step ------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_training_step_matches_the_references(spawned, references, cases,
                                              case, ref):
    """The first step's loss, ``grad_norm`` and every leaf's gradient,
    assembled from the processes' blocks (the MoE against the JAX
    package: its loss; the routed experts: no gradient, as the stacked
    step's)."""
    results = spawned[0][case]
    c = cases[case]
    want = references[case][ref]
    mine = [r["train"] for r in results]
    assert all(m["losses"] == mine[0]["losses"] for m in mine)
    assert abs(mine[0]["losses"][0] - want["loss"]) <= ATOL_LOSS
    if case in MOE:
        assert mine[0]["metrics"][0]["moe_dropped"] == 0
        if ref == "jax":
            return
    assert abs(mine[0]["grad_norms"][0] - want["grad_norm"]) <= \
        RTOL_GNORM * want["grad_norm"]
    got = _assembled_grads(results, c["cfg"], c["grid"])
    for n, w in want["grads"].items():
        if w is None:
            assert n.split(".")[-1] in ROUTED and not got[n].any(), n
            continue
        err = float((got[n] - w).abs().max())
        assert err <= RTOL_GRAD * float(w.abs().max()) + ATOL_GRAD, (n, err)


@pytest.mark.parametrize("case", list(CASES))
def test_training_collectives_equal_the_prediction(spawned, cases, case):
    """The step's collectives equal ``chip_smoke.train_collectives``'
    count from the layer pattern (the split-dim gather forward and in the
    recompute, its ``reduce_scatter`` backward; MLA's four exchanges
    forward, in the recompute and inverse in the backward), and every
    ``all_gather`` over ``model`` is an activation's
    (``chip_smoke.model_gathers``)."""
    results = spawned[0][case]
    c = cases[case]
    cfg, grid = c["cfg"], c["grid"]
    layout = serve_layout(cfg, grid[1])
    assert layout == CASES[case][4]
    t = results[0]["train"]
    p_specs = t["param_specs"]
    partial = any(partial_over_model(n, sp, cfg) for n, sp in p_specs.items())
    n_zero = sum(t["moment_specs"][n] != sp for n, sp in p_specs.items())
    want = train_collectives(cfg, layout, len(p_specs), partial, grid[0],
                             n_zero)
    gathers = model_gathers(cfg, layout, grid, SEQ)
    for r in results:
        assert r["train"]["counts"] == [want]
        got = [e["bytes"] for e in r["train"]["log"]
               if e["op"] == "all_gather" and e["axes"] == ["model"]]
        assert sorted(got) == sorted(gathers)


def test_k1_runs_in_the_moe_dispatch(spawned, cases):
    """K1's wrapper (its plain version on the CPU): 4 times a MoE layer
    a training step (the send pack and the regroup, forward and
    recompute), twice in the prefill, never in a decode step or in the
    other cases."""
    results, _ = spawned
    for case, c in cases.items():
        layers = c["cfg"].num_layers if case in MOE else 0
        for r in results[case]:
            assert r["train"]["k1_calls"] == 4 * layers, case
            assert r["serve"]["k1"] == [2 * layers, 0], case


# -- serving ----------------------------------------------------------------


def _rows(results, c, i):
    """The processes' logits of call ``i`` over the whole batch: the
    model ranks of a data row (every rank at a batch of one) hold the
    same bits."""
    grid = c["grid"]
    parts = []
    for data in range(grid[0]):
        got = [results[data * grid[1] + m]["serve"]["logits"][i]
               for m in range(grid[1])]
        assert all(torch.equal(g, got[0]) for g in got), i
        parts.append(got[0])
    if c["rows"] == 1:
        assert all(torch.equal(p, parts[0]) for p in parts), i
        return parts[0]
    return torch.cat(parts)


def _held(results, references, case, ref) -> int:
    """The calls held: all of them, or (a MoE) those before the first
    decode step whose routing differs from the reference's."""
    if case not in MOE:
        return STEPS + 1
    theirs = references[case][ref]["routes"]
    assert len(theirs) == STEPS
    def layers(routes):          # the JAX layers arrive in any order
        return sorted(np.asarray(a, np.int64).tobytes() for a in routes)
    for t in range(STEPS):
        mine = torch.cat([r["serve"]["routes"][t]
                          for r in results[::CASES[case][2][1]]], dim=1)
        if layers(mine.numpy()) != layers(theirs[t]):
            return t + 1
    return STEPS + 1


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_logits_match_the_references(spawned, references, cases, case,
                                     ref):
    """The prefill's next-token logits and each decode step's, every
    row's, over the real vocabulary."""
    results, _ = spawned
    c = cases[case]
    v = c["cfg"].vocab
    want = references[case][ref]["logits"]
    bound = ATOL_PORT if ref == "port" else ATOL_JAX
    held = _held(results[case], references, case, ref)
    assert held > 1
    for i in range(held):
        got = _rows(results[case], c, i)
        assert got.shape == want[i].shape
        err = float((got[..., :v].float() - want[i][..., :v]).abs().max())
        assert err <= bound, (i, err)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_caches_match_the_references(spawned, references, cases, case,
                                     ref):
    """The caches after the last step, assembled from the processes'
    blocks (every block the specs replicate the same bits on each rank
    holding it): ``pos`` exactly, every written slot within the bound
    (a MoE's written before its first rerouted step), every empty slot
    zero."""
    results, _ = spawned
    c = cases[case]
    grid = c["grid"]
    want = {k: v.float() if k != "pos" else v
            for k, v in references[case][ref]["caches"].items()}
    specs = build(c["cfg"]).batch_cache_specs(c["rows"], ("data",))
    got = {}
    for k, w in want.items():
        full = torch.full(w.shape, float("nan")) if k != "pos" else \
            torch.full(w.shape, -2, dtype=torch.int32)
        for r, res in enumerate(results[case]):
            sl = shard_slices(w.shape, specs[k], grid, AXES, r)
            block = res["serve"]["caches"][k].to(full.dtype)
            seen = full[sl]
            filled = ~torch.isnan(seen) if k != "pos" else seen != -2
            assert torch.equal(seen[filled], block[filled]), (k, r)
            full[sl] = block
        got[k] = full
    assert torch.equal(got["pos"], want["pos"].to(torch.int32))
    written = want["pos"] >= 0
    held = written & (want["pos"] < PROMPT - 1
                      + _held(results[case], references, case, ref))
    bound = ATOL_CACHE_PORT if ref == "port" else ATOL_CACHE_JAX
    for k in set(want) - {"pos"}:
        shape = written.shape + (1,) * (got[k].dim() - written.dim())
        err = float(((got[k] - want[k]).abs() * held.reshape(shape)).max())
        assert err <= bound, (k, err)
        assert not (got[k] * ~written.reshape(shape)).any(), k


@pytest.mark.parametrize("case", list(CASES))
def test_decode_collectives_equal_the_prediction(spawned, cases, case):
    """Each decode step's collectives equal ``chip_smoke``'s
    ``serve_collectives`` (the split-dim gather of the new keys and
    values a layer; MLA's four exchanges a layer)."""
    results, _ = spawned
    c = cases[case]
    cfg, grid = c["cfg"], c["grid"]
    want = serve_collectives(cfg, serve_layout(cfg, grid[1]), grid[0],
                             one_row=c["rows"] == 1)
    for r in results[case]:
        assert len(r["serve"]["counts"]) == STEPS
        assert all(cnt == want for cnt in r["serve"]["counts"])


def test_spawns_are_inside_their_limit(spawned):
    _, seconds = spawned
    assert seconds < TIMEOUT_S


# -- the layouts' arithmetic ------------------------------------------------


@pytest.mark.parametrize("heads,width,model", [(40, 96, 16), (40, 64, 16),
                                               (10, 24, 4), (10, 16, 4),
                                               (10, 8, 4), (40, 96, 32)])
def test_mla_piece_table_is_the_column_map(heads, width, model):
    """Each rank's block of ``heads x width`` columns sends each column
    to the rank owning its head (``floor(h model / H)``), and an owner
    receives, joined in rank order, exactly its heads' columns in
    order."""
    send, recv = mla_pieces(heads, width, model)
    block = heads * width // model
    owner = [h * model // heads for h in range(heads)]
    for j in range(model):
        assert list(mla_owned_heads(heads, model, j)) == [
            h for h in range(heads) if owner[h] == j]
    got = {j: [] for j in range(model)}
    for r in range(model):
        cols = range(r * block, (r + 1) * block)
        dest = [owner[col // width] for col in cols]
        assert dest == sorted(dest)        # consecutive pieces, rank order
        assert list(send[r]) == [dest.count(j) for j in range(model)]
        for col, j in zip(cols, dest):
            got[j].append(col)
    for j in range(model):
        assert list(recv[j]) == [send[r][j] for r in range(model)]
        heads_j = mla_owned_heads(heads, model, j)
        assert got[j] == list(range(heads_j.start * width,
                                    heads_j.stop * width))


@pytest.mark.parametrize("heads,kv,model", [(32, 4, 16), (32, 8, 16),
                                            (32, 4, 8)])
def test_kv_head_of_rank_is_its_query_heads(heads, kv, model):
    """Every query head of a rank's block uses the one KV head
    ``kv_head_of_rank`` gives; the ranks sharing a KV head are
    ``model / KV`` consecutive ones."""
    group = heads // kv
    for r in range(model):
        qs = range(r * heads // model, (r + 1) * heads // model)
        assert {q // group for q in qs} == {kv_head_of_rank(heads, kv,
                                                            model, r)}
        assert kv_head_of_rank(heads, kv, model, r) == r // (model // kv)


def test_kv_heads_that_do_not_divide_model_raise():
    """3 KV heads over 4 or 2 model ranks (neither split whole nor
    dividing the ranks) and MLA columns that do not divide raise, naming
    the shape; TinyLlama's 4 KV heads over 8 and 16 and MiniCPM3's 40
    heads over 16 take the new layouts."""
    cfg = dataclasses.replace(get_smoke_config("tinyllama_1_1b"),
                              d_model=96, n_heads=12, n_kv_heads=3)
    for model in (4, 2):
        c = dataclasses.replace(cfg, tp_size=model)
        with pytest.raises(ValueError, match=f"split-dim KV columns \\(3 KV "
                           f"heads over {model} model ranks\\)"):
            tp_layout(c, meta_params(c).blocks[0].attn, model)
    mla = dataclasses.replace(get_smoke_config("minicpm3_4b"), n_heads=3,
                              n_kv_heads=3, v_head_dim=5)
    with pytest.raises(ValueError, match="3 MLA heads do not split over 2 "
                       "model ranks: wv_up's 3 x 5 columns"):
        tp_layout(mla, meta_params(mla).blocks[0].attn, 2)
    tiny = get_config("tinyllama_1_1b")
    for model in (8, 16):
        assert tp_layout(tiny, meta_params(dataclasses.replace(
            tiny, num_layers=1)).blocks[0].attn, model) == "split_kv"
    minicpm = get_config("minicpm3_4b")
    assert tp_layout(minicpm, meta_params(dataclasses.replace(
        minicpm, num_layers=1)).blocks[0].attn, 16) == "split_heads"


@pytest.mark.parametrize("arch,model,reason", [
    ("tinyllama_1_1b", 8, None), ("tinyllama_1_1b", 16, None),
    ("qwen3_moe_30b_a3b", 8, None), ("qwen3_moe_30b_a3b", 16, None),
    ("h2o_danube_1_8b", 16, None), ("minicpm3_4b", 16, None),
    ("xlstm_125m", 16, "4 mlstm heads do not split over 16"),
    ("whisper_small", 16, "1500 encoder frames do not split over 16")])
def test_published_configs_on_the_grid(arch, model, reason):
    """``check_grid_layout`` takes the published configs whose heads
    split over ``model`` ranks, and still refuses xLSTM's heads and
    Whisper's encoder frames, with their reasons."""
    cfg = get_config(arch)
    if reason is None:
        check_grid_layout(cfg, model)
    else:
        with pytest.raises(ValueError, match=reason):
            check_grid_layout(cfg, model)


def test_gradient_leaves_of_the_split_layouts_are_whole(cases):
    """``wk``/``wv`` are column blocks with their own gradient (no
    ``psum`` of them over ``model``); ``q_norm``/``k_norm`` are
    replicated GQA leaves summed over ``model``; MLA's down projections
    hold their whole gradient."""
    for case in ("qwen3_moe", "mla_split"):
        cfg = cases[case]["cfg"]
        specs = build(cfg).param_specs()
        for n, sp in specs.items():
            if ".attn." not in n:
                continue
            last = n.split(".")[-1]
            if last in ("wk", "wv", "wq", "wq_up", "wk_up", "wv_up"):
                assert "model" in spec_axes(sp), n
            if last in ("q_norm", "k_norm") and cfg.attn_type != "mla":
                assert partial_over_model(n, sp, cfg), n
            if cfg.attn_type == "mla":
                assert not partial_over_model(n, sp, cfg), n
