"""Prefill and decode into caches over 4 gloo processes on ``(2, 2)``
``("data", "model")``, against the port's one process (its stacked
``Ranks`` on the same grid for the MoE) and against the JAX package's
``prefill`` and ``decode_step`` on a ``(2, 2)`` mesh, on the CPU.

One spawn runs every case (``tests/torch_serve_dist_paths.py``, no JAX)
with a hard ``timeout_s`` of its own, in a thread, while a subprocess
runs the JAX package on a ``(2, 2)`` ``repro.compat.make_mesh`` of 4
virtual CPU devices (XLA's excess precision off), its weights, batch
and caches placed by their specs (the caches by ``cache_specs(...,
dp=("data",))``), and this process computes the port's references. Each
process holds its blocks of the weights (``registry.process_params``),
its data rows of the batch and its blocks of the caches
(``init_caches(..., ranks=)``). The cases, smoke size:

- ``tinyllama``: smoke TinyLlama as it is (8 heads against ``tp_size``
  16: the sequence layout);
- ``tinyllama_heads``: ``tp_size=2`` (the heads layout: 4 query heads
  and 1 of the 2 KV heads a model rank; the cache keeps both KV heads,
  so each layer gathers the new keys and values over ``model``);
- ``tinyllama_ragged``: the same, the decode's rows at positions that
  differ (gaps of 0-5 slots left empty);
- ``granite``: ``tp_size=2``, one KV head (``wk``/``wv`` replicated),
  the GELU MLP;
- ``danube``: H2O-Danube, ``tp_size=2``, decoding past its window of
  16, so that the ring of 16 slots wraps;
- ``mla``: smoke MiniCPM3, 2 MLA heads a model rank;
- ``qwen2_moe``: smoke Qwen1.5-MoE with 16 experts, shared experts,
  attention by sequence: the prefill through the sphere shuffle (K1 in
  the send pack and the regroup), every decode step through the
  expert-sharded dense dispatch, whose capacity (1 slot an expert at 8
  tokens) is counted over both data rows;
- ``qwen3_moe``: smoke Qwen3-MoE with 16 experts and ``tp_size=2`` (q/k
  norms, the heads layout, the KV gather);
- ``internvl2``: 8 image embeddings in front of 8 tokens in the prefill;
- ``whisper``: the enc-dec (32 frames, a prompt of 16), each decode step
  carrying the encoder output.

Each prefills 16 positions into caches of 48 (the ring's 16 for
``danube``) and decodes 8 steps teacher-forced on tokens drawn from the
seed, so that every run sees the same inputs.

Bounds (the logits in float32 over the vocabulary; the caches bfloat16
at every written slot), each about twice its largest reading:

- logits against the port's reference within ``ATOL_PORT`` 0.0625
  (measured: 0 to 2e-5 for the sequence layout, MLA and the MoE; 0.016
  to 0.031 for the heads layout, whose products sum their float32 parts
  in another order and round once to bfloat16); against the JAX package
  within ``ATOL_JAX`` 0.25 (measured 0.016 to 0.114, MLA the largest:
  the JAX package on a mesh sums its sharded products' bfloat16 parts
  in its own way, and the port's one process reads the same distance
  from it to the digit);
- the caches' keys, values and latents against the port's reference
  within ``ATOL_CACHE_PORT`` 0.0625 (measured up to 0.0156), against the
  JAX package within ``ATOL_CACHE_JAX`` 0.125 (measured up to 0.052).

A top-k router is discontinuous: where two experts' probabilities lie
within a rounding, a token may take the other one, and with the
decode's capacity of one slot an expert, token-major, the slots of the
tokens after it too. So each MoE call is held to a reference up to the
first decode step whose routing differs from the processes' (both
routings recorded: the JAX package's through a host callback in its
dense dispatch), at most ``MAX_REROUTED`` 2 rows a step (measured: 1;
against the port's stacked reference qwen2-moe never, qwen3-moe from
step 6; against the JAX package from steps 1 and 5); ``moe_dropped`` is
the reference's at every call that routed alike and within the number
of moved expert choices at the others.

Exact: every cache's ``pos`` (which slots hold which positions); the
model ranks of a data row hold the same bits of the logits and of every
cache block the spec replicates over ``model``, and route alike; K1's
calls (2 a MoE layer a prefill, none in a decode); each process's cache
bytes against the specs' arithmetic; each decode step's collectives
against ``chip_smoke.serve_collectives``; and the named ``ValueError``
of every layout that is not ported.
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build as jax_build
from repro_torch.comm import Ranks, shard_slices, spawn_ranks
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import build
from repro_torch.models.convert import flatten, params_from_numpy
import torch_serve_dist_paths as spaths

from test_torch_jax_refs import SRC

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import serve_collectives, serve_layout  # noqa: E402

GRID, AXES = (2, 2), ("data", "model")
BATCH, PROMPT, MAX_LEN, STEPS = 8, 16, 48, 8
ATOL_PORT, ATOL_JAX = 0.0625, 0.25
ATOL_CACHE_PORT, ATOL_CACHE_JAX = 0.0625, 0.125
MAX_REROUTED = 2
TIMEOUT_S = 150
#: case: (arch, replaced config fields, each row's position offset)
CASES = {
    "tinyllama": ("tinyllama_1_1b", {}, None),
    "tinyllama_heads": ("tinyllama_1_1b", {"tp_size": 2}, None),
    "tinyllama_ragged": ("tinyllama_1_1b", {"tp_size": 2},
                         [0, 3, 1, 5, 2, 0, 4, 1]),
    "granite": ("granite_34b", {"tp_size": 2}, None),
    "danube": ("h2o_danube_1_8b", {"tp_size": 2}, None),
    "mla": ("minicpm3_4b", {}, None),
    "qwen2_moe": ("qwen2_moe_a2_7b", {"num_experts": 16}, None),
    "qwen3_moe": ("qwen3_moe_30b_a3b", {"num_experts": 16, "tp_size": 2},
                  None),
    "internvl2": ("internvl2_1b", {}, None),
    "whisper": ("whisper_small", {}, None),
}
MOE = ("qwen2_moe", "qwen3_moe")


def _inputs(cfg, offsets, seed: int) -> dict:
    """The prefill batch (``prefill.<name>``) and each decode step's
    ``tokens`` and ``pos`` (``step<t>.<name>``) as numpy arrays: tokens
    uniform over the vocabulary, image embeddings and frames normal,
    rounded to bfloat16 on use."""
    rng = np.random.default_rng(seed)
    text = PROMPT - (cfg.img_tokens if cfg.family == "vlm" else 0)
    out = {"prefill.tokens": rng.integers(0, cfg.vocab, (BATCH, text))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["prefill.img_embeds"] = rng.standard_normal(
            (BATCH, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["prefill.frames"] = rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    off = np.zeros(BATCH, np.int32) if offsets is None else np.asarray(
        offsets, np.int32)
    for t in range(STEPS):
        out[f"step{t}.tokens"] = rng.integers(
            0, cfg.vocab, (BATCH, 1)).astype(np.int32)
        out[f"step{t}.pos"] = (PROMPT + t + off)[:, None].astype(np.int32)
    return out


def _torch_inputs(arrays: dict) -> dict:
    """:func:`_inputs` as the paths take them: ``{"prefill": batch,
    "steps": [batch...], "max_len"}``, floats in bfloat16."""
    def conv(a):
        t = torch.from_numpy(np.array(a))
        return t.bfloat16() if t.is_floating_point() else t
    pre = {k.split(".", 1)[1]: conv(v) for k, v in arrays.items()
           if k.startswith("prefill.")}
    steps = [{name: conv(arrays[f"step{t}.{name}"])
              for name in ("tokens", "pos")} for t in range(STEPS)]
    return {"prefill": pre, "steps": steps, "max_len": MAX_LEN}


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, (arch, replace, offsets) in CASES.items():
        cfg = dataclasses.replace(get_smoke_config(arch), **replace)
        jcfg = dataclasses.replace(jax_smoke_config(arch), **replace)
        jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        arrays = _inputs(cfg, offsets, seed=zlib.crc32(name.encode()))
        out[name] = {"cfg": cfg, "tree": tree, "arrays": arrays,
                     "flat": {n: torch.from_numpy(np.array(v))
                              for n, v in flatten(tree).items()},
                     "inputs": _torch_inputs(arrays),
                     "jax": [arch, replace, BATCH, MAX_LEN]}
    return out


# -- the references ---------------------------------------------------------


def _port_reference(c) -> dict:
    """The port's one process (the MoE: its stacked ``Ranks`` on ``(2,
    2)``, which dispatches the prefill through the sphere shuffle and
    every decode step through the dense dispatch of the whole batch)."""
    cfg = c["cfg"]
    model = build(cfg)
    params = params_from_numpy(c["tree"], cfg, "cpu")
    rk = (Ranks(shape=GRID, axes=AXES, device="cpu")
          if cfg.family == "moe" else None)
    caches = model.init_caches(BATCH, MAX_LEN, "cpu")
    return spaths.serve(model, params, c["inputs"], caches, rk)


_JAX_CODE = """
    import dataclasses, json, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compat import make_mesh
    from repro.configs import get_smoke_config
    from repro.models import build, encdec, transformer
    from repro.models import moe as jmoe
    spec = json.loads(sys.argv[1])
    # each decode step's dense routing, to the host: (n, k) ids sorted
    ROUTES, TAP = [], [False]
    real_route = jmoe._route

    def route(params, x_flat, cfg):
        top_i, top_p, aux = real_route(params, x_flat, cfg)
        if TAP[0]:
            jax.debug.callback(
                lambda t: ROUTES.append(np.sort(np.asarray(t), axis=-1)),
                top_i)
        return top_i, top_p, aux
    jmoe._route = route
    mesh = make_mesh(tuple(spec["grid"]), tuple(spec["axes"]))
    data = dict(np.load(spec["inputs"]))
    NO_EXCESS = {"xla_allow_excess_precision": False}
    DP = ("data",)

    def put(tree, specs):
        return jax.tree.map(
            lambda s, a: jax.device_put(a, NamedSharding(mesh, s)), specs,
            tree, is_leaf=lambda x: isinstance(x, P))

    def rows(a):       # a batch of one is replicated over data
        return P("data" if a.shape[0] > 1 else None,
                 *([None] * (a.ndim - 1)))

    def batch_of(arrays):
        return {k: jax.device_put(
                    jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
                    else jnp.asarray(a), NamedSharding(mesh, rows(a)))
                for k, a in arrays.items()}

    def compiled(fn, *args):
        return jax.jit(fn).lower(*args).compile(NO_EXCESS)

    out = {}
    for name, (arch, replace, n_rows, max_len) in spec["cases"].items():
        cfg = dataclasses.replace(get_smoke_config(arch), **replace)
        model = build(cfg)
        moe = cfg.family == "moe"
        pre = name + ".prefill."
        with mesh:
            params, p_specs = model.init(jax.random.PRNGKey(0))
            params = put(params, p_specs)
            # a batch of one: long_500k's layout (the time axis over data)
            c_specs = model.cache_specs(
                "long_500k" if n_rows == 1 else "prefill_32k", dp=DP)
            caches = put(model.init_caches(n_rows, max_len), c_specs)
            batch = batch_of({k[len(pre):]: v for k, v in data.items()
                              if k.startswith(pre)})
            if moe:   # the prefill's body, with its drop count
                def prefill(p, b, c):
                    lg, c, aux = transformer.lm_forward(
                        p, cfg, b["tokens"], caches=c, mesh=mesh,
                        dp_axes=DP, last_only=True)
                    return lg, c, aux["moe_dropped"]

                def decode(p, c, b):
                    lg, c, aux = transformer.lm_forward(
                        p, cfg, b["tokens"], q_pos=b["pos"], caches=c,
                        mesh=mesh, dp_axes=DP)
                    return lg, c, aux["moe_dropped"]
            else:
                def prefill(p, b, c):
                    lg, c = model.prefill(p, b, c, mesh=mesh, dp_axes=DP)
                    return lg, c, jnp.float32(0)

                def decode(p, c, b):
                    lg, c = model.decode_step(p, c, b, mesh=mesh,
                                              dp_axes=DP)
                    return lg, c, jnp.float32(0)
            lg, caches, dropped = compiled(prefill, params, batch,
                                           caches)(params, batch, caches)
            logits, drops = [np.asarray(lg, np.float32)], [float(dropped)]
            enc_out = None
            if cfg.family == "audio":
                enc_out = compiled(lambda p, f: encdec.encode(p, cfg, f),
                                   params, batch["frames"])(
                                       params, batch["frames"])
            step_fn = None
            for t in range(spec["steps"]):
                sp = f"{name}.step{t}."
                b = batch_of({k[len(sp):]: v for k, v in data.items()
                              if k.startswith(sp)})
                if enc_out is not None:
                    b["enc_out"] = enc_out
                caches = put(caches, c_specs)    # each step's input layout
                if step_fn is None:
                    TAP[0] = moe
                    step_fn = compiled(decode, params, caches, b)
                    TAP[0] = False
                lg, caches, dropped = step_fn(params, caches, b)
                logits.append(np.asarray(lg, np.float32))
                drops.append(float(dropped))
                jax.effects_barrier()
                if ROUTES:
                    out[f"{name}.routes{t}"] = np.stack(ROUTES)
                    ROUTES.clear()
        for i, a in enumerate(logits):
            out[f"{name}.logits{i}"] = a
        out[name + ".dropped"] = np.asarray(drops)
        layers = caches if isinstance(caches, list) else [caches]
        for i, c in enumerate(layers):
            tag = f".{i}" if isinstance(caches, list) else ""
            for k, v in c.items():
                out[f"{name}.cache{tag}.{k}"] = np.asarray(
                    v, np.int32 if k == "pos" else np.float32)
    np.savez(spec["out"], **out)
"""


def _start_jax(cases, d, err):
    """The JAX package's prefill and decode steps of every case on a
    ``(2, 2)`` mesh of 4 virtual CPU devices, in a subprocess (started
    here, waited for later; its standard error to the file ``err``).
    Each case's ``"jax"`` entry: ``[arch, replaced fields, batch,
    caches' length]`` (a batch of one takes ``long_500k``'s cache specs,
    its row replicated over ``data``)."""
    arrays = {f"{name}.{k}": v for name, c in cases.items()
              for k, v in c["arrays"].items()}
    np.savez(d / "inputs.npz", **arrays)
    spec = {"grid": GRID, "axes": AXES, "steps": STEPS,
            "inputs": str(d / "inputs.npz"), "out": str(d / "out.npz"),
            "cases": {n: c["jax"] for n, c in cases.items()}}
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_allow_excess_precision=false")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_CODE), json.dumps(spec)],
        env=env, stdout=subprocess.DEVNULL, stderr=err)


def _jax_results(raw: dict, names) -> dict:
    """The JAX subprocess's results of the cases ``names``: a
    heterogeneous stack's caches as a list of per-layer dicts."""
    out = {}
    for name in names:
        caches = {}
        for k, v in raw.items():
            if k.startswith(name + ".cache"):
                *layer, leaf = k[len(name + ".cache"):].lstrip(".").split(".")
                caches.setdefault(int(layer[0]) if layer else None, {})[
                    leaf] = torch.from_numpy(v)
        out[name] = {
            "logits": [torch.from_numpy(raw[f"{name}.logits{i}"])
                       for i in range(STEPS + 1)],
            "routes": [raw[f"{name}.routes{t}"] for t in range(STEPS)
                       if f"{name}.routes{t}" in raw],
            "dropped": [float(v) for v in raw[name + ".dropped"]],
            "caches": (caches[None] if None in caches else
                       [caches[i] for i in sorted(caches)])}
    return out


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """The spawn (in a thread) and the JAX subprocess, started first; the
    port's references meanwhile."""
    inputs = {name: {k: c[k] for k in ("cfg", "flat", "inputs")}
              for name, c in cases.items()}
    d = tmp_path_factory.mktemp("serve_ref")
    t0 = time.perf_counter()
    with open(d / "stderr.txt", "w") as err:
        proc = _start_jax(cases, d, err)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            job = pool.submit(spawn_ranks, spaths.run_cases, GRID, AXES,
                              device="cpu", timeout_s=TIMEOUT_S,
                              args=(inputs,))
            refs = {name: {"port": _port_reference(c)}
                    for name, c in cases.items()}
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


@pytest.fixture(scope="module")
def spawned(runs):
    return runs[0], runs[1]


@pytest.fixture(scope="module")
def references(runs):
    return runs[2]


def _data_rows(results, case, what, i=None):
    """The processes' ``what`` (or its ``i``-th entry) joined over the
    data rows, after checking that the model ranks of each data row hold
    the same bits."""
    parts = []
    for data in range(GRID[0]):
        ranks = [results[data * GRID[1] + m][case][what] for m in
                 range(GRID[1])]
        if i is not None:
            ranks = [r[i] for r in ranks]
        assert all(torch.equal(r, ranks[0]) for r in ranks), (case, what, i)
        parts.append(ranks[0])
    return torch.cat(parts)


def _assembled_caches(results, case, cfg, shapes):
    """Every cache leaf assembled from the processes' blocks by the
    specs, each block that the specs replicate the same bits on every
    rank that holds it."""
    specs = build(cfg).batch_cache_specs(BATCH, ("data",))
    out = {}
    for k, shape in shapes.items():
        full = torch.full(shape, float("nan")) if k != "pos" else \
            torch.full(shape, -2, dtype=torch.int32)
        for r, res in enumerate(results):
            sl = shard_slices(shape, specs[k], GRID, AXES, r)
            block = res[case]["caches"][k].to(full.dtype)
            seen = full[sl]
            filled = ~torch.isnan(seen) if k != "pos" else seen != -2
            assert torch.equal(seen[filled], block[filled]), (case, k, r)
            full[sl] = block
        out[k] = full
    return out


# -- logits and caches against the references --------------------------------


def _rerouted(mine, theirs) -> tuple:
    """The rows whose experts differ in some layer between two runs'
    routing of one decode step (``(layers, rows, k)`` each; the JAX
    package's layers come in the order its host callbacks arrived, so
    each of ``mine`` is matched to the layer of ``theirs`` it differs
    from least), and the number of differing expert choices."""
    left = [torch.as_tensor(np.asarray(j)).to(torch.int32) for j in theirs]
    rows, moved = set(), 0
    assert len(left) == len(mine)
    for r in mine:
        diffs = [(r.to(torch.int32) != j) for j in left]
        best = min(range(len(left)), key=lambda i: int(diffs[i].sum()))
        d = diffs[best]
        left.pop(best)
        rows |= set(torch.nonzero(d.any(-1))[:, 0].tolist())
        moved += int(d.sum())
    return rows, moved


def _process_routes(results, case, t):
    """The processes' routing of decode step ``t``, ``(layers, rows,
    k)``, joined over the data rows (the model ranks of a row route
    alike)."""
    mine = [r[case]["routes"][t] for r in results]
    assert all(torch.equal(m, mine[r - r % GRID[1]])
               for r, m in enumerate(mine)), t
    return torch.cat(mine[::GRID[1]], dim=1)


def _rerouted_calls(results, references, case, ref) -> list:
    """Each call's rows that the reference routed otherwise than the
    processes (the prefill's: none; no MoE: none) and the expert choices
    it moved; ``MAX_REROUTED`` rows at most a step."""
    out = [(set(), 0)]
    if case not in MOE:
        return out * (STEPS + 1)
    theirs = references[case][ref]["routes"]
    assert len(theirs) == STEPS
    for t in range(STEPS):
        rows, moved = _rerouted(_process_routes(results, case, t),
                                theirs[t])
        assert len(rows) <= MAX_REROUTED, (t, rows)
        out.append((rows, moved))
    return out


def _held(results, references, case, ref) -> int:
    """The calls held to a reference: all of them, or those before the
    first decode step whose routing differs (a top-k router is
    discontinuous: from there the capacity's token-major slots and the
    caches carry a difference of rounding on as a different result)."""
    moved = [bool(rows) for rows, _ in _rerouted_calls(
        results, references, case, ref)]
    return moved.index(True) if any(moved) else STEPS + 1


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_logits_match_the_references(spawned, references, cases, case,
                                     ref):
    """The prefill's next-token logits (the enc-dec's at every position)
    and each decode step's, every data row's, over the real vocabulary;
    against the JAX package, a MoE's calls up to its first rerouted
    step (``_held``)."""
    results, _ = spawned
    v = cases[case]["cfg"].vocab
    want = references[case][ref]["logits"]
    bound = ATOL_PORT if ref == "port" else ATOL_JAX
    held = _held(results, references, case, ref)
    for i in range(STEPS + 1):
        got = _data_rows(results, case, "logits", i)
        assert got.shape == want[i].shape, (i, got.shape, want[i].shape)
        assert (got[..., v:] == -1e30).all()
        if i < held:
            err = float((got[..., :v].float() - want[i][..., :v])
                        .abs().max())
            assert err <= bound, (i, err)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_caches_match_the_references(spawned, references, cases, case,
                                     ref):
    """The caches after the last step, assembled from the processes'
    blocks: ``pos`` exactly, every written slot's entries within the
    bound, every empty slot zero; against the JAX package, a MoE's slots
    written before its first rerouted step."""
    results, _ = spawned
    want = {k: v.float() if k != "pos" else v
            for k, v in references[case][ref]["caches"].items()}
    got = _assembled_caches(results, case, cases[case]["cfg"],
                            {k: tuple(v.shape) for k, v in want.items()})
    assert set(got) == set(want)
    assert torch.equal(got["pos"], want["pos"].to(torch.int32))
    written = want["pos"] >= 0
    assert written.any() and not written.all() or case == "danube"
    held = written & (want["pos"] < PROMPT - 1
                      + _held(results, references, case, ref))
    bound = ATOL_CACHE_PORT if ref == "port" else ATOL_CACHE_JAX
    for k in set(want) - {"pos"}:
        g, w = got[k], want[k]
        shape = written.shape + (1,) * (g.dim() - written.dim())
        err = float(((g - w).abs() * held.reshape(shape)).max())
        assert err <= bound, (k, err)
        assert not (g * ~written.reshape(shape)).any(), k


@pytest.mark.parametrize("case", MOE)
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_moe_dropped_matches_the_references(spawned, references, case,
                                            ref):
    """``moe_dropped`` of the prefill (data row 0's, the sphere
    dispatch's convention) and of every decode step (the whole batch's,
    its capacity counted over both data rows): the reference's count at
    every call that routed alike, else within the number of expert
    choices it moved (a drop count depends on the per-expert counts
    alone); every process the same."""
    results, _ = spawned
    got = [r[case]["dropped"] for r in results]
    assert all(g == got[0] for g in got)
    assert len(got[0]) == STEPS + 1
    assert sum(got[0][1:]) > 0          # the decode's capacity drops
    want = references[case][ref]["dropped"]
    for i, (rows, moved) in enumerate(_rerouted_calls(results, references,
                                                      case, ref)):
        assert abs(got[0][i] - want[i]) <= moved, (i, got[0][i], want[i])
        if not rows:
            assert got[0][i] == want[i], i


def test_k1_runs_in_the_moe_prefill_only(spawned, cases):
    """K1's wrapper (its plain version on the CPU): twice a MoE layer in
    every process's prefill (the send pack and the regroup), never in a
    decode step or another family."""
    results, _ = spawned
    for case, c in cases.items():
        want = [2 * c["cfg"].num_layers, 0] if case in MOE else [0, 0]
        assert all(r[case]["k1"] == want for r in results), case


# -- what a process holds and issues -----------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_cache_bytes_are_the_specs_blocks(spawned, cases, case):
    """Each process allocates only its blocks of the caches: their bytes
    equal the specs' arithmetic over the whole caches' shapes."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    model = build(cfg)
    whole = model.init_caches(BATCH, MAX_LEN, "meta")
    specs = model.batch_cache_specs(BATCH, ("data",))
    for r, res in enumerate(results):
        want = 0
        for k, t in whole.items():
            sl = shard_slices(t.shape, specs[k], GRID, AXES, r)
            want += t[sl].numel() * t.element_size()
        assert res[case]["cache_bytes"] == want, (r, want)
    full = sum(t.numel() * t.element_size() for t in whole.values())
    assert results[0][case]["cache_bytes"] < full


@pytest.mark.parametrize("case", list(CASES))
def test_decode_collectives_equal_the_prediction(spawned, cases, case):
    """Every decode step's collectives equal the count from the layer
    count that ``chip_smoke.py``'s serving cells also hold the card's
    processes to (``serve_collectives``)."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    want = serve_collectives(cfg, serve_layout(cfg, GRID[1]), GRID[0])
    for res in results:
        assert len(res[case]["counts"]) == STEPS
        for counts in res[case]["counts"]:
            assert counts == want


def test_what_is_not_ported_raises(spawned):
    """Split KV heads that do not divide the model ranks (3 over 4, on a
    ``(1, 4)`` grid over the same processes), 3 MLA heads of 5 value
    columns over 2 model ranks, 6 experts that
    pad to 16 in the weights and to 6 for 2 expert ranks, and the MoE at
    a batch of one over 2 data ranks (the decode's all_gather of
    per-expert counts would count its replicated row once a data rank)
    raise, each naming what is not ported; nothing else of
    ``raising_cases`` does (the time-sharded and recurrent caches are
    ``tests/test_torch_serve_dist_recurrent.py``'s)."""
    results, _ = spawned
    for res in results:
        msgs = res["raises"]
        assert set(msgs) == {"split_kv", "mla_heads", "padding",
                             "moe_one_row"}
        assert "split-dim KV columns (3 KV heads over 4 model ranks" in \
            msgs["split_kv"]
        assert "3 MLA heads do not split over 2" in msgs["mla_heads"]
        assert "pad 6 experts to 6" in msgs["padding"]
        assert "the MoE at batch 1 over a data axis of more than one " \
            "rank is not ported" in msgs["moe_one_row"]


def test_processes_start_from_the_source_weights(cases):
    """``process_params`` cuts each process's block from the source
    bit for bit, and ``init(ranks=)`` draws the blocks of the one
    process's weights from the same seed (the whole model on a fake
    4-rank grid, rank 3)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.comm import ProcessRanks
    from repro_torch.models.registry import process_params
    dist.init_process_group("fake", store=FakeStore(), world_size=4, rank=3)
    try:
        ranks = ProcessRanks(GRID, AXES, device="cpu")
        for case in ("tinyllama_heads", "mla", "qwen2_moe", "whisper"):
            c = cases[case]
            cfg = c["cfg"]
            got = process_params(cfg, ranks, source=c["flat"])
            one = params_from_numpy(c["tree"], cfg, "cpu")
            drawn = build(cfg).init(torch.Generator().manual_seed(7),
                                    ranks=ranks)
            whole = build(cfg).init(torch.Generator().manual_seed(7), "cpu")
            specs = build(cfg).param_specs()
            wp = dict(whole.named_parameters())
            for n, p in one.named_parameters():
                sl = shard_slices(p.shape, specs[n], GRID, AXES, 3)
                assert torch.equal(got.get_parameter(n), p[sl]), (case, n)
                assert torch.equal(drawn.get_parameter(n), wp[n][sl]), n
    finally:
        dist.destroy_process_group()


def test_cache_specs_by_batch_are_the_shapes_specs():
    """``batch_cache_specs(b)`` is ``cache_specs`` of a shape of ``b``
    rows; a batch of one shards the time axis unless the attention is
    sliding-window."""
    from repro_torch.configs.base import SHAPES
    for arch in ("tinyllama_1_1b", "minicpm3_4b", "h2o_danube_1_8b",
                 "whisper_small"):
        model = build(get_smoke_config(arch))
        for shape, sp in SHAPES.items():
            assert model.batch_cache_specs(sp.global_batch, ("data",)) == \
                model.cache_specs(shape, ("data",)), (arch, shape)
    tiny = build(get_smoke_config("tinyllama_1_1b"))
    assert tiny.batch_cache_specs(1, ("data",))["k"] == \
        (None, None, "data", None, None)
    swa = build(get_smoke_config("h2o_danube_1_8b"))
    assert swa.batch_cache_specs(1, ("data",))["k"][2] is None


def test_spawn_is_inside_its_limit(spawned):
    _, seconds = spawned
    assert seconds < TIMEOUT_S
