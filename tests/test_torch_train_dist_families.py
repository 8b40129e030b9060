"""The MoE and MLA decoders trained over 4 gloo processes on ``(2, 2)``
``("data", "model")`` (``jit_train_step`` over the shards
``init_train_state(..., ranks=)`` cuts) against the port's stacked step on
the same grid (MoE) or its one-process step (MLA), and against the JAX
package's step, on the CPU.

One spawn runs every case (``tests/torch_train_dist_families_paths.py``,
no JAX) with a hard ``timeout_s`` of its own, in a thread, while this
process computes the port's references and a subprocess runs the JAX
package's ``jit_train_step`` on a ``(2, 2)`` ``repro.compat.make_mesh``
of 4 virtual CPU devices (XLA's excess precision off). The cases, 3
steps each:

- ``qwen2_moe``: smoke qwen2-moe with 16 experts (its 6 do not pad alike
  for the weights and for 2 expert ranks), shared experts, attention
  sequence-parallel (4 heads against ``tp_size`` 16);
- ``qwen3_moe``: smoke qwen3-moe with 16 experts and ``tp_size`` 2: q/k
  norms, the heads sharded, one KV head a rank;
- ``mla``: smoke MiniCPM3, 2 MLA heads a rank; against the one-process
  step and the JAX package's unsharded step.

The weights are the JAX package's ``init`` at ``PRNGKey(0)``; the batches
consecutive blocks of the repo's corpus (``synthetic_tokens``), 8
sequences of 32 tokens.

Bounds. The first step (the same weights) is held to the port's own
reference by ``tests/test_torch_train_dist.py``'s bounds: the loss
within ``ATOL_LOSS`` 2e-3 (measured 5e-7 MoE, 2.9e-6 MLA), ``grad_norm``
within ``RTOL_GNORM`` 5e-3 relative (measured 1.4e-4), each leaf's
gradient within ``RTOL_GRAD`` 3% of its largest value plus ``ATOL_GRAD``
1e-3 (measured 0.9-1.2%), the router's within ``RTOL_ROUTER`` 1e-4 of
its largest value (measured 4e-7) and within 3% of the JAX mesh step's
(measured 1.7%), where data row 0's ``moe_aux`` alone gives a gradient
off by more than ``WRONG_ROUTER`` 10%. After it the two references
disagree with each other beyond those bounds: a top-k router is
discontinuous, and the weights one update moves by ``2 lr`` where a
near-zero gradient's rounding flips its sign send some of a batch's 256
tokens to other experts. Measured, the port's stacked step against the
JAX mesh step: losses up to 5.2e-3 (qwen2-moe, step 2) and 2.1e-2
(qwen3-moe, step 3) apart, norms 2.1e-2 (1% relative); the parameters'
99th percentile 0.119 ``sum(lr)`` (the trainer tests' rule,
``tests/test_torch_train.py``, asks 0.05); MLA's
one-process step against JAX's unsharded one 0.061 (no router: AdamW's
sign flips alone). At the first step the port's stacked step and the
JAX mesh step are 2.2e-3 apart in loss for qwen2-moe (near-tie tokens
routed otherwise), so the JAX step is held within the later bounds from
the first step on. The processes against either reference: losses up to
2.1e-2 apart (qwen3-moe at step 3, against the stacked step; 2e-4
against the JAX step), norms 9.4e-3 relative (qwen2-moe at step 3,
against the JAX step), the 99th percentile up to 0.094 ``sum(lr)``, the
median at most 0.0042 ``sum(lr)``. So after the first step the bounds
are fixed at about twice those readings: each loss within
``LATER_ATOL_LOSS`` 0.05, each ``grad_norm`` within ``LATER_RTOL_GNORM``
2% relative, and the parameters after the last step by the trainer
tests' rule with its 99% threshold at ``RULE_P99`` 0.2 ``sum(lr)``
(every one within ``2 * sum(lr)``, half within ``0.005 * sum(lr)``).

Exact: the processes' losses, norms and metrics agree to the bit; every
model rank holds the same bits of a replicated leaf's gradient; the
routed experts get no gradient and are decayed alone, to the same bits
as in the stacked step; the first step's ``moe_aux`` and ``moe_dropped``
are the stacked step's (the same routing from the same weights); the
collectives a step are a count from the layer count.
"""

import concurrent.futures
import dataclasses
import json
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
from repro.train import optimizer as jopt
from repro.train.trainer import build_train_step as jax_train_step
from repro_torch.comm import Ranks, shard_slices, spawn_ranks, spec_axes
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data import synthetic_tokens
from repro_torch.models import build
from repro_torch.models.attention import tp_layout
from repro_torch.models.convert import flatten, named_leaves, params_from_numpy
from repro_torch.models.moe import padded_experts, plan_experts
from repro_torch.models.registry import meta_params
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import (build_train_step, jit_train_step,
                                       loss_and_grads, partial_over_model)
import torch_train_dist_families_paths as fpaths
import torch_train_dist_paths as paths

from test_torch_jax_refs import SRC

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import train_collectives  # noqa: E402  (imports no JAX)

GRID, AXES = (2, 2), ("data", "model")
STEPS, BATCH, SEQ = 3, 8, 32
OPT = topt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
NO_EXCESS = {"xla_allow_excess_precision": False}
ATOL_LOSS = 2e-3
RTOL_GNORM = 5e-3
RTOL_GRAD, ATOL_GRAD = 0.03, 1e-3
RTOL_ROUTER = 1e-4
WRONG_ROUTER = 0.1
LATER_ATOL_LOSS, LATER_RTOL_GNORM, RULE_P99 = 0.05, 0.02, 0.2
TIMEOUT_S = 150
#: case: (arch, replaced config fields)
CASES = {"qwen2_moe": ("qwen2_moe_a2_7b", {"num_experts": 16}),
         "qwen3_moe": ("qwen3_moe_30b_a3b", {"num_experts": 16,
                                             "tp_size": 2}),
         "mla": ("minicpm3_4b", {})}
MOE = ("qwen2_moe", "qwen3_moe")
ROUTED = ("w_gate", "w_up", "w_down")


def _batches(vocab):
    toks = synthetic_tokens(STEPS * BATCH * (SEQ + 1), vocab)
    return [{"tokens": b[:, :-1].copy(), "labels": b[:, 1:].copy()}
            for b in toks.reshape(STEPS, BATCH, SEQ + 1)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, (arch, replace) in CASES.items():
        cfg = dataclasses.replace(get_smoke_config(arch), **replace)
        jcfg = dataclasses.replace(jax_smoke_config(arch), **replace)
        jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        out[name] = {"cfg": cfg, "jcfg": jcfg, "jparams": jparams,
                     "tree": tree, "flat": flatten(tree),
                     "batches": _batches(cfg.vocab)}
    return out


# -- the references ---------------------------------------------------------


def _port_reference(c):
    """The port's stacked step on ``(2, 2)`` (MoE) or its one-process step
    (MLA): losses, norms, lrs, metrics, the first batch's gradient and
    the parameters after the last step."""
    cfg = c["cfg"]
    model = build(cfg)
    rk = (Ranks(shape=GRID, axes=AXES, device="cpu")
          if cfg.family == "moe" else None)
    params = params_from_numpy(c["tree"], cfg, "cpu", dtype=torch.float32)
    _, _, g = loss_and_grads(model, params, _torch_batch(c["batches"][0]),
                             rk)
    out = {"grads": {n: None if t is None else t.detach().clone()
                     for n, t in g.items()},
           "losses": [], "grad_norms": [], "lrs": [], "metrics": []}
    state = topt.init_opt_state(named_leaves(params, cfg))
    step = build_train_step(model, OPT, rk)
    for b in c["batches"]:
        _, _, m = step(params, state, _torch_batch(b))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        for key, k in (("losses", "loss"), ("grad_norms", "grad_norm"),
                       ("lrs", "lr")):
            out[key].append(float(m[k]))
    out["params"] = {n: p.detach() for n, p in params.named_parameters()}
    return out


def _jax_unsharded(c):
    """The JAX package's step without a mesh (the MLA case)."""
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


_MESH_CODE = """
    import dataclasses, json, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compat import make_mesh
    from repro.configs import get_smoke_config
    from repro.data import synthetic_tokens
    from repro.models import build
    from repro.train import optimizer as jopt
    from repro.train.trainer import jit_train_step
    spec = json.loads(sys.argv[1])
    mesh = make_mesh(tuple(spec["grid"]), tuple(spec["axes"]))
    out = {}
    for name, (arch, replace) in spec["cases"].items():
        cfg = dataclasses.replace(get_smoke_config(arch), **replace)
        model = build(cfg)
        params, p_specs = model.init(jax.random.PRNGKey(0))
        steps, b, s = spec["steps"], spec["batch"], spec["seq"]
        toks = synthetic_tokens(steps * b * (s + 1), cfg.vocab)
        toks = toks.reshape(steps, b, s + 1)
        b_specs = {"tokens": P("data", None), "labels": P("data", None)}
        with mesh:
            f = jax.value_and_grad(
                lambda p, bt: model.train_loss(p, bt, mesh=mesh),
                has_aux=True)
            b0 = {"tokens": jnp.asarray(toks[0, :, :-1]),
                  "labels": jnp.asarray(toks[0, :, 1:])}
            (_, met), g = jax.jit(f)(params, b0)
            out[name + ".grad.router"] = np.asarray(
                g["blocks"]["moe"]["router"], np.float32)
            out[name + ".moe_aux0"] = np.asarray(met["moe_aux"])
            out[name + ".moe_dropped0"] = np.asarray(met["moe_dropped"])
            step, (p_sh, o_sh, b_sh) = jit_train_step(
                model, jopt.AdamWConfig(**spec["opt"]), mesh, p_specs,
                b_specs)
            opt = jax.device_put(jopt.init_opt_state(params), o_sh)
            p = jax.device_put(params, p_sh)
            losses, norms = [], []
            for i in range(steps):
                bt = {"tokens": jax.device_put(toks[i, :, :-1],
                                               b_sh["tokens"]),
                      "labels": jax.device_put(toks[i, :, 1:],
                                               b_sh["labels"])}
                p, opt, m = step(p, opt, bt)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        out[name + ".losses"] = np.asarray(losses)
        out[name + ".grad_norms"] = np.asarray(norms)
        for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
            key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            out[name + ".param." + key] = np.asarray(leaf, np.float32)
    np.savez(spec["out"], **out)
"""


def _start_mesh_reference(out_path, err):
    """The JAX package's ``jit_train_step`` of the MoE cases on a ``(2,
    2)`` mesh of 4 virtual CPU devices, and its first-step router
    gradient, in a subprocess (started here, waited for later; its
    standard error to the file ``err``)."""
    spec = {"grid": GRID, "axes": AXES, "steps": STEPS, "batch": BATCH,
            "seq": SEQ, "opt": dataclasses.asdict(OPT), "out": out_path,
            "cases": {n: CASES[n] for n in MOE}}
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_allow_excess_precision=false")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_MESH_CODE), json.dumps(spec)],
        env=env, stdout=subprocess.DEVNULL, stderr=err)


def _mesh_results(raw):
    """``{case: {"losses", "grad_norms", "router" (L, d, E), "moe_aux0",
    "moe_dropped0", "params" by port name}}`` from the subprocess's
    arrays."""
    out = {}
    for name in MOE:
        pre = name + "."
        tree = {}
        for k, v in raw.items():
            if k.startswith(pre + "param."):
                node = tree
                parts = k[len(pre + "param."):].split(".")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = v
        out[name] = {"losses": list(raw[pre + "losses"]),
                     "grad_norms": list(raw[pre + "grad_norms"]),
                     "router": raw[pre + "grad.router"],
                     "moe_aux0": float(raw[pre + "moe_aux0"]),
                     "moe_dropped0": float(raw[pre + "moe_dropped0"]),
                     "params": {n: torch.from_numpy(np.asarray(v))
                                for n, v in flatten(tree).items()}}
    return out


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """The spawn (in a thread) and the JAX mesh subprocess, started first;
    the port's references and the JAX unsharded MLA step meanwhile."""
    inputs = {name: {"cfg": c["cfg"],
                     "batches": [_torch_batch(b) for b in c["batches"]],
                     "flat": {n: torch.from_numpy(np.array(v))
                              for n, v in c["flat"].items()}}
              for name, c in cases.items()}
    d = tmp_path_factory.mktemp("mesh_ref")
    mesh_out = str(d / "out.npz")
    t0 = time.perf_counter()
    with open(d / "stderr.txt", "w") as err:
        proc = _start_mesh_reference(mesh_out, err)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            job = pool.submit(spawn_ranks, fpaths.run_cases, GRID, AXES,
                              device="cpu", timeout_s=TIMEOUT_S,
                              args=(inputs, OPT))
            refs = {name: {"port": _port_reference(c)}
                    for name, c in cases.items()}
            refs["mla"]["jax"] = _jax_unsharded(cases["mla"])
            results = job.result()
        seconds = time.perf_counter() - t0
        proc.wait(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, (d / "stderr.txt").read_text()
    for name, r in _mesh_results(dict(np.load(mesh_out))).items():
        refs[name]["jax"] = r
    return results, seconds, refs


@pytest.fixture(scope="module")
def spawned(runs):
    return runs[0], runs[1]


@pytest.fixture(scope="module")
def references(runs):
    return runs[2]


def _assembled(results, case, name, shape):
    """The first step's reduced gradient of leaf ``name``, assembled from
    the processes' blocks."""
    specs = results[0][case]["grad_specs"]
    full = torch.empty(shape)
    for r, res in enumerate(results):
        full[shard_slices(shape, specs[name], GRID, AXES, r)] = \
            res[case]["grads"][name]
    return full


# -- the step against its references ------------------------------------------


def _rule(got, want, s) -> np.ndarray:
    """The trainer tests' rule's three numbers over the parameters: the
    max, the 99th percentile and the median of the differences, over
    ``s``."""
    d = torch.cat([(got[n] - want[n]).abs().reshape(-1) for n in want])
    return np.array([float(d.max()), float(torch.quantile(d, 0.99)),
                     float(d.median())]) / s


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_losses_and_norms_match_the_references(spawned, references, case,
                                               ref):
    results, _ = spawned
    mine = [r[case] for r in results]
    for key in ("losses", "grad_norms", "lrs", "metrics"):
        assert all(r[key] == mine[0][key] for r in mine), key
    got, want = mine[0], references[case][ref]
    port = references[case]["port"]
    # the first step, from the same weights, against the port's own step
    assert abs(got["losses"][0] - port["losses"][0]) <= ATOL_LOSS
    assert abs(got["grad_norms"][0] - port["grad_norms"][0]) <= \
        RTOL_GNORM * port["grad_norms"][0]
    # every step, within the first step's bounds or, after an update (and
    # at every step against the JAX step), the fixed later ones
    dl = np.abs(np.subtract(got["losses"], want["losses"]))
    first = ATOL_LOSS if ref == "port" else LATER_ATOL_LOSS
    assert (dl <= [first] + [LATER_ATOL_LOSS] * (STEPS - 1)).all()
    dg = np.abs(np.subtract(got["grad_norms"], want["grad_norms"]))
    assert (dg <= np.abs(want["grad_norms"]) * (
        [RTOL_GNORM] + [LATER_RTOL_GNORM] * (STEPS - 1))).all()
    np.testing.assert_array_equal(got["lrs"], port["lrs"])
    moe = ["moe_aux", "moe_dropped"] if case in MOE else []
    assert got["metrics_keys"] == sorted(["grad_norm", "loss", "lr"] + moe)
    assert got["steps"] == STEPS


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_parameters_match_the_references(spawned, references, case, ref):
    """The trainer tests' rule, its 99% threshold at ``RULE_P99``."""
    results, _ = spawned
    got = results[0][case]["params"]
    assert all(r[case]["params"] is None for r in results[1:])
    s = sum(references[case]["port"]["lrs"])
    bound = np.array([2.0, RULE_P99, 0.005])
    assert (_rule(got, references[case][ref]["params"], s) <= bound).all()


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
def test_replicated_leaves_hold_the_whole_gradient(spawned, references,
                                                   cases, case):
    """Every model rank holds the same bits of each leaf replicated along
    ``model`` (the router and MLA's down projections and norms among
    them); every leaf's gradient, assembled, is the reference's first
    gradient (the routed experts': none, zeros on the processes)."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    specs = results[0][case]["param_specs"]
    replicated = [n for n, sp in specs.items()
                  if "model" not in spec_axes(sp)]
    if case in MOE:
        assert any(n.endswith(".moe.router") for n in replicated)
    else:
        assert {n.split(".")[-1] for n in replicated if ".attn." in n} == \
            {"wq_down", "q_norm", "wkv_down", "kv_norm"}
        assert not any(partial_over_model(n, specs[n], cfg) for n in specs)
    for n in replicated:
        for data in range(GRID[0]):
            blocks = [results[data * GRID[1] + m][case]["grads"][n]
                      for m in range(GRID[1])]
            assert all(torch.equal(b, blocks[0]) for b in blocks), n
    want = references[case]["port"]["grads"]
    shapes = {n: tuple(p.shape) for n, p in
              meta_params(cfg).named_parameters()}
    for n, w in want.items():
        full = _assembled(results, case, n, shapes[n])
        if n.split(".")[-1] in ROUTED and case in MOE:
            assert w is None and not full.any(), n
            continue
        err = float((full - w).abs().max())
        assert err <= RTOL_GRAD * float(w.abs().max()) + ATOL_GRAD, n


@pytest.mark.parametrize("case", MOE)
def test_router_gradient_is_every_data_rows(spawned, references, cases,
                                            case, monkeypatch):
    """The router's first-step gradient: the stacked step's within
    ``RTOL_ROUTER`` of its largest value, and both within ``RTOL_GRAD`` of
    the JAX mesh step's, where data row 0's ``moe_aux`` alone (the port's
    stacked step before this rule) is off by more than ``WRONG_ROUTER``."""
    from repro_torch.models import moe
    results, _ = spawned
    c = cases[case]
    cfg = c["cfg"]
    port = references[case]["port"]["grads"]

    class RowZeroOnly(torch.autograd.Function):
        @staticmethod
        def forward(ctx, rows, value):
            ctx.shape = rows.shape
            return value.detach().clone()

        @staticmethod
        def backward(ctx, g):
            out = g.new_zeros(ctx.shape)
            out[0] = g
            return out, None
    monkeypatch.setattr(moe, "_RowZeroValue", RowZeroOnly)
    params = params_from_numpy(c["tree"], cfg, "cpu", dtype=torch.float32)
    _, _, row0 = loss_and_grads(build(cfg), params,
                                _torch_batch(c["batches"][0]),
                                Ranks(shape=GRID, axes=AXES, device="cpu"))
    for i in range(cfg.num_layers):
        n = f"blocks.{i}.moe.router"
        mesh = torch.from_numpy(references[case]["jax"]["router"][i])
        top = float(mesh.abs().max())
        got = _assembled(results, case, n, tuple(mesh.shape))
        assert float((got - port[n]).abs().max()) <= RTOL_ROUTER * top, n
        for g in (got, port[n]):
            assert float((g - mesh).abs().max()) <= RTOL_GRAD * top, n
        assert float((row0[n] - mesh).abs().max()) > WRONG_ROUTER * top, n


@pytest.mark.parametrize("case", MOE)
def test_routed_experts_decay_only(spawned, references, cases, case):
    """The routed experts take no gradient: their AdamW update is the
    decay alone, to the same bits as in the stacked step."""
    results, _ = spawned
    got = results[0][case]["params"]
    want = references[case]["port"]["params"]
    init = cases[case]["flat"]
    routed = [n for n in got if n.split(".")[-1] in ROUTED]
    assert routed
    for n in routed:
        assert torch.equal(got[n], want[n]), n
        w0 = torch.from_numpy(np.asarray(init[n]))
        assert float((got[n] - w0).abs().max()) <= \
            sum(references[case]["port"]["lrs"]) * OPT.weight_decay * \
            float(w0.abs().max()) * 1.01, n


@pytest.mark.parametrize("case", MOE)
def test_moe_aux_and_dropped_are_the_stacked_steps(spawned, references,
                                                   case):
    """The first step (the same weights, so the same routing): ``moe_aux``
    and ``moe_dropped`` are data row 0's, as on stacked ranks and in the
    JAX mesh step."""
    results, _ = spawned
    got = results[0][case]["metrics"][0]
    port = references[case]["port"]["metrics"][0]
    mesh = references[case]["jax"]
    assert got["moe_dropped"] == port["moe_dropped"] == mesh["moe_dropped0"]
    assert abs(got["moe_aux"] - port["moe_aux"]) <= 1e-6 * port["moe_aux"]
    assert abs(got["moe_aux"] - mesh["moe_aux0"]) <= ATOL_LOSS


@pytest.mark.parametrize("case", MOE)
def test_k1_runs_four_times_a_moe_layer_a_step(spawned, cases, case):
    """K1's wrapper (its plain version on the CPU) runs in the send pack
    and the regroup, in the forward and in the remat recompute."""
    results, _ = spawned
    want = 4 * cases[case]["cfg"].num_layers * STEPS
    assert all(r[case]["k1_calls"] == want for r in results)
    assert all(r["mla"]["k1_calls"] == 0 for r in results)


# -- collectives ------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_a_step_equal_the_prediction(spawned, cases, case):
    """Every step's collectives equal the count from the layer count that
    ``chip_smoke.py`` phase 17 also holds the card's processes to
    (``train_collectives``)."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    layout = paths.layouts(cfg, GRID[1])[0]
    specs = build(cfg).param_specs()
    partial = any(partial_over_model(n, sp, cfg) for n, sp in specs.items())
    assert partial == (case in MOE)
    want = train_collectives(cfg, layout, len(specs), partial, GRID[0])
    for res in results:
        for counts in res[case]["counts"]:
            assert counts == want


@pytest.mark.parametrize("case", list(CASES))
def test_no_weight_is_gathered_over_model(spawned, cases, case):
    """The ``all_gather``s over ``model`` move activations only: a MoE
    layer's output blocks and the sequence-parallel attention's query
    rows, ``(B / data, S / model, d)`` bfloat16 each; every other runs
    over ``data`` (ZeRO-1's slices)."""
    results, _ = spawned
    cfg = cases[case]["cfg"]
    block = BATCH // GRID[0] * SEQ // GRID[1] * cfg.d_model * 2
    layout = paths.layouts(cfg, GRID[1])[0]
    per_layer = (case in MOE) + 2 * (layout == "sequence")
    for res in results:
        gathers = [e for e in res[case]["log"] if e["op"] == "all_gather"]
        over_model = [e["bytes"] for e in gathers if e["axes"] == ["model"]]
        assert over_model == [block] * (per_layer * cfg.num_layers)
        assert all(e["axes"] in (["model"], ["data"]) for e in gathers)


# -- what raises ------------------------------------------------------------


def test_what_is_not_ported_raises(spawned):
    """On ``(2, 2)``: 6 experts pad to 16 in the weights but to 6 for 2
    expert ranks; 3 MLA heads of 5 value columns, 1 xLSTM head and 3
    Mamba2 heads do not split over 2 ranks; smoke xLSTM, zamba2, whisper and internvl2 (the
    SSM, hybrid, enc-dec and VLM families) build."""
    results, _ = spawned
    for res in results:
        msgs = res["raises"]
        assert "pad 6 experts to 6" in msgs["padding"]
        assert "3 MLA heads do not split over 2" in msgs["mla_heads"]
        assert "1 mlstm heads do not split over 2 ranks of the model " \
            "axis" in msgs["xlstm_heads"]
        assert "3 mamba heads do not split over 2 ranks of the model " \
            "axis" in msgs["mamba_heads"]
        for arch in ("xlstm_125m", "zamba2_1_2b", "whisper_small",
                     "internvl2_1b"):
            assert msgs[arch] == "", arch


def test_published_configs_raise_where_they_do_not_split():
    """Qwen1.5-MoE's 60 experts pad alike only on 8 or 16 expert ranks;
    MiniCPM3's 40 MLA heads split over 16 model ranks mid-head (the
    split-heads layout), and raise where a weight's columns do not
    divide into the model ranks' blocks (``wk_up``'s 40 x 64 over 3)."""
    qwen = get_config("qwen2_moe_a2_7b")
    e_weights = padded_experts(qwen)
    assert e_weights == 64
    for m in (8, 16):
        assert plan_experts(qwen, e_weights, m) == 64
    with pytest.raises(ValueError, match="4 expert ranks pad 60 experts"):
        plan_experts(qwen, e_weights, 4)
    cfg = get_config("minicpm3_4b")
    attn = meta_params(dataclasses.replace(cfg, num_layers=1)).blocks[0].attn
    assert tp_layout(cfg, attn, 4) == "heads"
    assert tp_layout(cfg, attn, 8) == "heads"
    assert tp_layout(cfg, attn, 16) == "split_heads"
    with pytest.raises(ValueError, match="40 MLA heads do not split"):
        tp_layout(cfg, attn, 3)


def test_stacked_moe_step_reaches_no_model_parallel_code(monkeypatch, cases):
    """On stacked ranks the MoE step never takes a sharded path: with the
    differentiable collectives made to raise, ``jit_train_step`` on a
    ``(2, 2)`` ``Ranks`` is ``build_train_step``, to the bit."""
    from repro_torch import comm

    def refuse(*a, **k):
        raise AssertionError("a stacked step reached a model-parallel path")
    for fn in (comm._CopyTo, comm._ReduceFrom, comm._GatherFrom):
        monkeypatch.setattr(fn, "apply", refuse)
    c = cases["qwen2_moe"]
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

