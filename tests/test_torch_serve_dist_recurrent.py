"""Prefill and decode into caches over 4 gloo processes on ``(2, 2)``
``("data", "model")`` for the recurrent families (Mamba2, mLSTM, sLSTM)
and the time-sharded attention cache of a batch of one, against the
port's one process and against the JAX package's ``prefill`` and
``decode_step`` on a ``(2, 2)`` mesh (its caches placed by its own
``cache_specs``), on the CPU.

One spawn runs every case (``tests/torch_serve_dist_paths.py``, no JAX)
in a thread while the JAX subprocess of ``tests/test_torch_serve_dist.py``
(``_start_jax``) runs the JAX package and this process the port's
references. Each process holds its blocks of the weights, its data rows
of the batch (every data rank the whole row of a batch of one) and its
blocks of every cache leaf (``init_caches(..., ranks=)``). The cases,
smoke size, each a prompt of 16 and 8 decode steps teacher-forced:

- ``xlstm``: smoke xLSTM, batch 8: mLSTM's and sLSTM's 2 heads kept
  whole in the caches (16 does not divide them), so each mLSTM layer
  gathers its new states over ``model``;
- ``xlstm_heads16``: 16 heads: mLSTM's and sLSTM's states owned by head
  (sLSTM gathers its state before the recurrence every rank runs whole);
- ``zamba2``: smoke zamba2, batch 8: Mamba2's 2 heads kept whole and
  gathered; the shared block in the sequence layout;
- ``zamba2_wide``: ``d_model=512`` (16 Mamba2 heads, owned) and
  ``tp_size=2`` (the shared block by heads, its KV heads gathered);
- ``xlstm_one_row``: smoke xLSTM at batch 1: its states and conv
  windows replicated over ``data`` (no attention cache to shard);
- ``zamba2_long``: batch 1 into caches of 48: the shared block's cache
  time-sharded over ``data`` (slots 0-23 and 24-47), the decode at
  positions 20-27, so that both blocks are written and read, and the
  prefill's positions all lie in the first block (the second gives zero
  weight);
- ``tinyllama_long``: batch 1, ``tp_size=2``, the same positions: the
  time-sharded GQA cache with KV heads gathered;
- ``mla_long``: batch 1, the same positions: MLA's time-sharded latent
  cache;
- ``danube_long``: batch 1: the SWA ring (16 slots, wrapping) replicated
  over ``data``, no time shard.

Bounds, those of ``tests/test_torch_serve_dist.py``: the logits within
``ATOL_PORT`` 0.0625 of the port's one process and ``ATOL_JAX`` 0.25 of
the JAX package; the attention caches' written slots within
``ATOL_CACHE_PORT`` 0.0625 and ``ATOL_CACHE_JAX`` 0.125. The recurrent
states (float32, of any size: mLSTM's ``C`` sums ``v k^T`` over the
prompt, Mamba2's states stay below 0.05 at its small ``dt``) are held
relative to each leaf's largest entry, within ``RTOL_STATE_PORT`` and
``RTOL_STATE_JAX`` 0.05, about twice the largest readings (0 to 0.025
against the one process, 0 to 0.025 against the JAX package, zamba2's
Mamba2 states the largest; xLSTM's 0.004 to 0.012); the conv windows
(bfloat16) within the caches' bounds (read up to 0.043 and 0.055).
Measured: the logits 0 to 0.047 from the one process (the time-sharded
cases 0 to 0.016) and 0.031 to 0.10 from the JAX package; the attention
caches up to 0.047 and 0.066. Exact:
every cache's ``pos``; the bits every rank holds of a block the specs
replicate, and of the logits over a data row (over every rank at a batch
of one); each decode step's collectives against
``chip_smoke.serve_collectives``; each process's cache bytes against the
specs' blocks; which positions each time block holds.
"""

import concurrent.futures
import dataclasses
import os
import sys
import time
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build as jax_build
from repro_torch.comm import shard_slices, spawn_ranks
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import build
from repro_torch.models.convert import flatten, params_from_numpy
import torch_serve_dist_paths as spaths

from test_torch_serve_dist import (ATOL_CACHE_JAX, ATOL_CACHE_PORT,
                                   ATOL_JAX, ATOL_PORT, AXES, GRID, PROMPT,
                                   STEPS, _jax_results, _start_jax)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import serve_collectives, serve_layout  # noqa: E402

RTOL_STATE_PORT, RTOL_STATE_JAX = 0.05, 0.05
TIMEOUT_S = 150
#: the decode of the batch-one cases with a time-sharded cache starts at
#: position ``PROMPT + OFFSET`` = 20: its 8 steps straddle slot 24, the
#: first slot of the second data rank's block of 48
OFFSET = 4
#: case: (arch, replaced config fields, batch, caches' length, the decode
#: positions' offset)
CASES = {
    "xlstm": ("xlstm_125m", {}, 8, 48, 0),
    "xlstm_heads16": ("xlstm_125m", {"ssm_heads": 16, "n_heads": 16,
                                     "n_kv_heads": 16}, 8, 48, 0),
    "zamba2": ("zamba2_1_2b", {}, 8, 48, 0),
    "zamba2_wide": ("zamba2_1_2b", {"d_model": 512, "tp_size": 2}, 8, 48,
                    0),
    "xlstm_one_row": ("xlstm_125m", {}, 1, 48, 0),
    "zamba2_long": ("zamba2_1_2b", {}, 1, 48, OFFSET),
    "tinyllama_long": ("tinyllama_1_1b", {"tp_size": 2}, 1, 48, OFFSET),
    "mla_long": ("minicpm3_4b", {}, 1, 48, OFFSET),
    "danube_long": ("h2o_danube_1_8b", {}, 1, 48, 0),
}
ONE_ROW = [n for n, c in CASES.items() if c[2] == 1]
TIME_SHARDED = ["zamba2_long", "tinyllama_long", "mla_long"]
#: the recurrent state leaves (float32), held relative to their size
STATES = ("ssm", "C", "n", "m", "c", "h")


def _inputs(cfg, batch: int, offset: int, seed: int) -> dict:
    """The prefill's tokens (``prefill.tokens``) and each decode step's
    ``tokens`` and ``pos`` (``step<t>.<name>``) as numpy arrays, tokens
    uniform over the vocabulary."""
    rng = np.random.default_rng(seed)
    out = {"prefill.tokens": rng.integers(0, cfg.vocab, (batch, PROMPT))
           .astype(np.int32)}
    for t in range(STEPS):
        out[f"step{t}.tokens"] = rng.integers(
            0, cfg.vocab, (batch, 1)).astype(np.int32)
        out[f"step{t}.pos"] = np.full((batch, 1), PROMPT + offset + t,
                                      np.int32)
    return out


def _torch_inputs(arrays: dict, max_len: int) -> dict:
    pre = {k.split(".", 1)[1]: torch.from_numpy(np.array(v))
           for k, v in arrays.items() if k.startswith("prefill.")}
    steps = [{name: torch.from_numpy(np.array(arrays[f"step{t}.{name}"]))
              for name in ("tokens", "pos")} for t in range(STEPS)]
    return {"prefill": pre, "steps": steps, "max_len": max_len}


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, (arch, replace, batch, max_len, offset) in CASES.items():
        cfg = dataclasses.replace(get_smoke_config(arch), **replace)
        jcfg = dataclasses.replace(jax_smoke_config(arch), **replace)
        tree = jax.tree.map(np.asarray,
                            jax_build(jcfg).init(jax.random.PRNGKey(0))[0])
        arrays = _inputs(cfg, batch, offset, zlib.crc32(name.encode()))
        out[name] = {"cfg": cfg, "tree": tree, "arrays": arrays,
                     "batch": batch, "max_len": max_len,
                     "flat": {n: torch.from_numpy(np.array(v))
                              for n, v in flatten(tree).items()},
                     "inputs": _torch_inputs(arrays, max_len),
                     "jax": [arch, replace, batch, max_len]}
    return out


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """The spawn (in a thread) and the JAX subprocess, started first; the
    port's one process meanwhile."""
    inputs = {name: {k: c[k] for k in ("cfg", "flat", "inputs")}
              for name, c in cases.items()}
    d = tmp_path_factory.mktemp("serve_recurrent_ref")
    t0 = time.perf_counter()
    with open(d / "stderr.txt", "w") as err:
        proc = _start_jax(cases, d, err)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            job = pool.submit(spawn_ranks, spaths.run_cases, GRID, AXES,
                              device="cpu", timeout_s=TIMEOUT_S,
                              args=(inputs, False))
            refs = {}
            for name, c in cases.items():
                model = build(c["cfg"])
                params = params_from_numpy(c["tree"], c["cfg"], "cpu")
                caches = model.init_caches(c["batch"], c["max_len"], "cpu")
                refs[name] = {"port": spaths.serve(model, params,
                                                   c["inputs"], caches)}
            results = job.result()
        seconds = time.perf_counter() - t0
        proc.wait(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, (d / "stderr.txt").read_text()
    for name, r in _jax_results(dict(np.load(d / "out.npz")),
                                cases).items():
        refs[name]["jax"] = r
    return results, seconds, refs


def _layers(caches) -> list:
    return caches if isinstance(caches, list) else [caches]


def _logits(results, case, batch: int, i: int) -> torch.Tensor:
    """Call ``i``'s logits joined over the data rows, after checking that
    the ranks that hold a row hold the same bits (every rank at a batch
    of one)."""
    every = [r[case]["logits"][i] for r in results]
    if batch == 1:
        assert all(torch.equal(e, every[0]) for e in every), (case, i)
        return every[0]
    m = GRID[1]
    for d in range(GRID[0]):
        assert all(torch.equal(every[d * m + k], every[d * m])
                   for k in range(m)), (case, i)
    return torch.cat(every[::m])


def _assembled(results, case, cfg, batch, want) -> list:
    """Every cache leaf of every layer assembled from the processes'
    blocks by the specs (each block the specs replicate the same bits on
    every rank that holds it)."""
    specs = _layers(build(cfg).batch_cache_specs(batch, ("data",)))
    out = []
    for i, layer in enumerate(_layers(want)):
        got = {}
        for k, w in layer.items():
            full = (torch.full(w.shape, -2, dtype=torch.int32) if k == "pos"
                    else torch.full(w.shape, float("nan")))
            for r, res in enumerate(results):
                sl = shard_slices(w.shape, specs[i][k], GRID, AXES, r)
                block = _layers(res[case]["caches"])[i][k].to(full.dtype)
                seen = full[sl]
                filled = seen != -2 if k == "pos" else ~torch.isnan(seen)
                assert torch.equal(seen[filled], block[filled]), (case, i, k)
                full[sl] = block
            got[k] = full
        out.append(got)
    return out


@pytest.fixture(scope="module")
def spawned(runs):
    return runs[0], runs[1]


@pytest.fixture(scope="module")
def references(runs):
    return runs[2]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_logits_match_the_references(spawned, references, cases, case,
                                     ref):
    """The prefill's next-token logits and each decode step's, every
    data row's, over the real vocabulary, finite."""
    results, _ = spawned
    c = cases[case]
    v = c["cfg"].vocab
    bound = ATOL_PORT if ref == "port" else ATOL_JAX
    for i in range(STEPS + 1):
        got = _logits(results, case, c["batch"], i)
        want = references[case][ref]["logits"][i]
        assert got.shape == want.shape, (i, got.shape, want.shape)
        assert torch.isfinite(got).all(), i
        err = float((got[..., :v].float() - want[..., :v]).abs().max())
        assert err <= bound, (i, err)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_caches_match_the_references(spawned, references, cases, case,
                                     ref):
    """The caches after the last step, assembled from the processes'
    blocks: an attention cache's ``pos`` exactly, its written slots
    within the caches' bound and its empty slots zero; a recurrent
    state within its relative bound; a conv window within the caches'
    bound."""
    results, _ = spawned
    c = cases[case]
    want = _layers(references[case][ref]["caches"])
    got = _assembled(results, case, c["cfg"], c["batch"], want)
    bound = ATOL_CACHE_PORT if ref == "port" else ATOL_CACHE_JAX
    rtol = RTOL_STATE_PORT if ref == "port" else RTOL_STATE_JAX
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        if "pos" in w:
            assert torch.equal(g["pos"], w["pos"].to(torch.int32)), i
            written = w["pos"] >= 0
            assert written.any() and (not written.all()
                                      or case == "danube_long"), i
        for k in set(w) - {"pos"}:
            gk, wk = g[k], w[k].float()
            if "pos" in w:
                shape = written.shape + (1,) * (gk.dim() - written.dim())
                err = float(((gk - wk).abs() * written.reshape(shape)).max())
                assert err <= bound, (i, k, err)
                assert not (gk * ~written.reshape(shape)).any(), (i, k)
            elif k in STATES:
                err = float((gk - wk).abs().max())
                assert err <= rtol * float(wk.abs().max()), (i, k, err)
            else:
                err = float((gk - wk).abs().max())
                assert err <= bound, (i, k, err)


@pytest.mark.parametrize("case", TIME_SHARDED)
def test_time_blocks_hold_their_own_slots(spawned, cases, case):
    """At a batch of one each data rank's block holds exactly the
    positions whose slots fall in it, each at ``slot - block_start``:
    the prompt's in the first block, the decode's both (a write at
    ``pos % T_block`` would put them in every data rank's block)."""
    results, _ = spawned
    T = cases[case]["max_len"] // GRID[0]
    positions = set(range(PROMPT)) | {PROMPT + OFFSET + t
                                      for t in range(STEPS)}
    for r, res in enumerate(results):
        d = r // GRID[1]
        for layer in _layers(res[case]["caches"]):
            if "pos" not in layer:
                continue
            pos = layer["pos"].reshape(-1, T)
            want = torch.full((T,), -1, dtype=torch.int32)
            for p in positions:
                if d * T <= p < (d + 1) * T:
                    want[p - d * T] = p
            assert all(torch.equal(row, want) for row in pos), (r, d)
            assert (want >= 0).any()


@pytest.mark.parametrize("case", ONE_ROW)
def test_one_row_is_replicated_over_data(spawned, cases, case):
    """A batch of one: every process holds the one row, and every rank
    computes the same bits of it (``_logits`` checks the logits of every
    call); the caches that the specs replicate over ``data`` (the
    recurrent states, the SWA ring) the same bits on both data ranks."""
    results, _ = spawned
    for i in range(STEPS + 1):
        _logits(results, case, 1, i)
    specs = _layers(build(cases[case]["cfg"]).batch_cache_specs(
        1, ("data",)))
    for i, layer in enumerate(specs):
        for k, spec in layer.items():
            if "data" in spec:
                continue
            blocks = [_layers(r[case]["caches"])[i][k] for r in results]
            assert all(torch.equal(blocks[r], blocks[r % GRID[1]])
                       for r in range(len(blocks))), (i, k)


@pytest.mark.parametrize("case", list(CASES))
def test_cache_bytes_are_the_specs_blocks(spawned, cases, case):
    """Each process allocates only its blocks of the caches: their bytes
    equal the specs' arithmetic over the whole caches' shapes."""
    results, _ = spawned
    c = cases[case]
    model = build(c["cfg"])
    whole = _layers(model.init_caches(c["batch"], c["max_len"], "meta"))
    specs = _layers(model.batch_cache_specs(c["batch"], ("data",)))
    for r, res in enumerate(results):
        want = sum(t[shard_slices(t.shape, sp[k], GRID, AXES, r)].numel()
                   * t.element_size()
                   for layer, sp in zip(whole, specs)
                   for k, t in layer.items())
        assert res[case]["cache_bytes"] == want, (r, want)
    full = sum(t.numel() * t.element_size() for layer in whole
               for t in layer.values())
    # the SWA ring at a batch of one: every leaf replicated
    assert results[0][case]["cache_bytes"] < full or case == "danube_long"


@pytest.mark.parametrize("case", list(CASES))
def test_decode_collectives_equal_the_prediction(spawned, cases, case):
    """Every decode step's collectives equal ``serve_collectives``' count
    from the layer pattern, which phase 19 of ``chip_smoke.py`` also
    holds the card's processes to: the recurrent layers' exchange, sums
    and state gathers, and the time-sharded attention's ``pmax`` and two
    sums over ``data``."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    want = serve_collectives(cfg, serve_layout(cfg, GRID[1]), GRID[0],
                             one_row=cases[case]["batch"] == 1)
    for res in results:
        assert len(res[case]["counts"]) == STEPS
        for counts in res[case]["counts"]:
            assert counts == want


def test_spawn_is_inside_its_limit(spawned):
    _, seconds = spawned
    assert seconds < TIMEOUT_S
