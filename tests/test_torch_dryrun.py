"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

(a) Its analytic columns equal the JAX dry run's arithmetic for every
architecture, runnable shape and production grid (the JAX side on a stub
mesh and ``jax.eval_shape``: a 256-device mesh cannot be built here).
(b) At smoke size on a ``(2, 2)`` grid (on ``(1, 4)`` for the split-dim
KV and MLA's split heads), each family's train, prefill and decode
program (and the hybrid's decode at a batch of one, its attention caches
time-sharded over ``data``) traced on a fake process group
(``dryrun.trace``) makes
the same collectives (calls, bytes by op and axes, the converted bytes)
and counts the same FLOPs and K1 calls as the program run by 4 gloo CPU
processes (``tests/torch_dryrun_paths.py``). (c) Full-width cells on the
``(16, 16)`` grid through the command line: Granite-34B's ``decode_32k``
and Qwen1.5-MoE-A2.7B's ``train_4k`` count FLOPs within a band over the
model FLOPs (:data:`FLOP_BAND`), the cells whose heads split over the
model ranks (:data:`SPLIT`) within it over what their layout computes
(:func:`layout_flops`), and the cells the port cannot run are
``skipped`` with their reasons. (d) The command line writes a JSON a
cell and exits 0. Besides, the three repairs tracing needed, each held
on its own. Every trace runs in a process of its own (the fake default
process group never stays in the test's process).
"""

import dataclasses
import functools
import importlib
import json
import math
import os
import subprocess
import sys
import threading
import types

import pytest
import torch

import torch_dryrun_paths as paths
from repro_torch.comm import ProcessRanks, spawn_ranks, spec_axes
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, \
    get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
ENV = dict(os.environ, PYTHONPATH=SRC + os.pathsep + HERE)

#: every (arch, shape, mesh) the JAX dry run lowers (not skipped)
CELLS = [(a, s, m) for a in ARCH_IDS for s in get_config(a).runnable_shapes()
         for m in ("single", "multi")]
#: the full-width cells traced through the command line
FULL = {"granite_34b__decode_32k": ("granite_34b", "decode_32k"),
        "qwen2_moe_a2_7b__train_4k": ("qwen2_moe_a2_7b", "train_4k")}
#: counted FLOPs a device over the model FLOPs a device plus the
#: attention's score and value products the model FLOPs leave out
#: (:func:`attention_flops`). Above 1: the remat recompute (each layer's
#: attention forward again in the backward), the MoE's routed-expert
#: products at their capacity (factor 1.25, 60 experts padded to 64)
#: and the shared experts' gate; the readings 1.03 (Granite decode) and
#: 1.16 (the MoE's training step). An order of magnitude below 1 is the
#: trap of a batch cut twice (a process's rows handed to a step that
#: cuts them again).
FLOP_BAND = (1.0, 1.35)
#: the full-width cells whose attention heads split over the 16 model
#: ranks: split-dim KV (TinyLlama's and Qwen3-MoE's 4 KV heads,
#: H2O-Danube's 8) and MiniCPM3's 40 MLA heads
SPLIT = {"tinyllama_1_1b__train_4k": ("tinyllama_1_1b", "train_4k"),
         "qwen3_moe_30b_a3b__decode_32k": ("qwen3_moe_30b_a3b",
                                           "decode_32k"),
         "h2o_danube_1_8b__long_500k": ("h2o_danube_1_8b", "long_500k"),
         "minicpm3_4b__train_4k": ("minicpm3_4b", "train_4k")}


def _run(cmd, timeout=600):
    return subprocess.run(cmd, env=ENV, capture_output=True, text=True,
                          timeout=timeout)


# -- (a) the analytic columns -----------------------------------------------


@pytest.fixture(scope="module")
def jax_dr():
    """The JAX package's dry run, imported after JAX's backend is up (its
    import sets 512 host devices for a process that has none yet), with
    the environment it changes put back."""
    import jax
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    dr = importlib.import_module("repro.launch.dryrun")
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return dr


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    import jax
    from repro.configs import get_config as jax_config
    from repro.models.registry import build as jax_build
    model = jax_build(jax_config(arch))
    box = {}

    def init_only(k):
        p, s = model.init(k)
        box["specs"] = s
        return p

    sds = jax.eval_shape(init_only, jax.random.PRNGKey(0))
    return model, sds, box["specs"]


def _jax_columns(dr, arch, shape, multi, zero1=True, bf16=False):
    """The JAX dry run's analytic numbers of a cell, as its
    ``lower_cell`` computes them (a stub mesh: they read its shape)."""
    import jax
    import jax.numpy as jnp
    from repro.train.optimizer import init_opt_state, zero1_specs
    model, sds, specs = _jax_model(arch)
    mesh = types.SimpleNamespace(shape=dict(
        make_production_mesh(multi_pod=multi).sizes))
    p_sds = (jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape,
                                                         jnp.bfloat16), sds)
             if bf16 else sds)
    state = dr.analytic_param_bytes(p_sds, specs, mesh)
    if SHAPES[shape].kind == "train":
        mspec = (zero1_specs(specs, sds, data_axes=("data",),
                             mesh_shape=dict(mesh.shape))
                 if zero1 and "data" in mesh.shape else specs)
        m_sds = jax.eval_shape(lambda p: init_opt_state(p, master=bf16),
                               p_sds)["m"]
        state += 2 * dr.analytic_param_bytes(m_sds, mspec, mesh)
    chips = math.prod(mesh.shape.values())
    mf = dr.model_flops(model, p_sds, shape)
    n = sum(l.size for l in jax.tree.leaves(p_sds))
    return {"state_bytes_per_device": int(state),
            "moe_active_fraction": dr.moe_active_fraction(model, p_sds),
            "model_flops_global": mf, "model_flops_per_device": mf / chips,
            "analytic_hbm_bytes_per_device": dr.analytic_hbm_bytes(
                model.cfg, shape, mesh, n, zero1=zero1)}


def _assert_columns_equal(port, want):
    assert set(port) == set(want)
    for k, v in want.items():
        if isinstance(v, int):
            assert port[k] == v, k
        else:
            assert port[k] == pytest.approx(v, rel=1e-12, abs=0), k


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=["-".join(c) for c in CELLS])
def test_analytic_columns_equal_the_jax_dry_runs(jax_dr, arch, shape, mesh):
    multi = mesh == "multi"
    port = dryrun.analytic_columns(get_config(arch), SHAPES[shape],
                                   make_production_mesh(multi_pod=multi))
    _assert_columns_equal(port, _jax_columns(jax_dr, arch, shape, multi))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("zero1,bf16", [(False, False), (True, True)],
                         ids=["no_zero1", "bf16_params"])
def test_analytic_train_state_options_equal_the_jax_dry_runs(jax_dr, arch,
                                                             zero1, bf16):
    port = dryrun.analytic_columns(get_config(arch), SHAPES["train_4k"],
                                   make_production_mesh(multi_pod=True),
                                   zero1=zero1, bf16_params=bf16)
    _assert_columns_equal(port, _jax_columns(jax_dr, arch, "train_4k", True,
                                             zero1=zero1, bf16=bf16))


def test_param_leaves_are_the_jax_trees(jax_dr):
    """Leaf by leaf: the JAX tree's shapes and specs (a stacked leaf's
    layers one leaf)."""
    import jax
    for arch in ARCH_IDS:
        _, sds, specs = _jax_model(arch)
        want = [(tuple(l.shape), tuple(s)) for l, s in zip(
            jax.tree.leaves(sds),
            jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)))]
        got = [(x.shape, x.spec + (None,) * (len(x.shape) - len(x.spec)))
               for x in dryrun.param_leaves(get_config(arch))]
        want = [(sh, sp + (None,) * (len(sh) - len(sp))) for sh, sp in want]
        assert got == want, arch


# -- (b), (c), (d): traces in processes of their own --------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process this file's traces need, started at once: the 4
    gloo processes of the smoke programs (a thread), the same programs
    traced (one process a family), and the command line's cells."""
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {}
    for fam in paths.FAMILIES:
        out = str(tmp / f"fake_{fam}.pt")
        procs[f"fake_{fam}"] = (subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_dryrun_paths.py"),
             fam, out], env=ENV, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    cli = str(tmp / "cli")
    for name, (arch, shape) in {**FULL, **SPLIT}.items():
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", cli], env=ENV,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            os.path.join(cli, f"{name}__single.json"))
    both = str(tmp / "both")
    procs["both"] = (subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internvl2_1b", "--shape", "decode_32k", "--mesh", "both", "--out",
         both], env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), both)
    real = {}

    def gloo():
        try:
            real["ranks"] = spawn_ranks(
                paths.real_programs, paths.GRID, paths.AXES, backend="gloo",
                device="cpu", timeout_s=300, args=(list(paths.FAMILIES),))
        except BaseException as e:      # raised in the test below
            real["error"] = e

    thread = threading.Thread(target=gloo)
    thread.start()
    done = {}
    try:
        for name, (p, out) in procs.items():
            text, _ = p.communicate(timeout=600)
            done[name] = (p.returncode, text, out)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
        thread.join()
    return done, real


def _fake(runs, fam):
    code, text, out = runs[0][f"fake_{fam}"]
    assert code == 0, text
    return torch.load(out, weights_only=False)


def _real(runs):
    real = runs[1]
    if "error" in real:
        raise real["error"]
    return real["ranks"]


CASES = [(f, k) for f in paths.FAMILIES for k in paths.shapes(f)]


@pytest.mark.parametrize("fam,kind", CASES, ids=["-".join(c) for c in CASES])
def test_trace_equals_real_gloo_processes(runs, fam, kind):
    fake = _fake(runs, fam)[(fam, kind)]
    real = _real(runs)[0][(fam, kind)]
    assert fake["calls"] == real["calls"]
    assert fake["ops"] == real["ops"]
    assert fake["bytes"] == real["bytes"]
    assert fake["counts"] == real["counts"]
    assert fake["flops"] == real["flops"] > 0
    assert fake["flops_by_op"] == real["flops_by_op"]
    assert fake["k1_calls"] == real["k1_calls"]
    if fam == "moe" and kind != "decode":
        assert fake["k1_calls"] > 0          # the sphere dispatch's K1
    assert sum(fake["bytes"].values()) > 0


def test_every_gloo_process_runs_one_program(runs):
    """Rank 0's program (the one the dry run traces) is every rank's; where
    the ranks attend unequal numbers of heads (MLA's split heads) the
    same collectives, and rank 0, which owns the most heads, counts the
    most FLOPs."""
    ranks = _real(runs)
    for r in ranks[1:]:
        for case, got in r.items():
            if case[0] in paths.UNEVEN:
                assert got["ops"] == ranks[0][case]["ops"], case
                assert {k: v["calls"] for k, v in got["calls"].items()} \
                    == {k: v["calls"] for k, v in
                        ranks[0][case]["calls"].items()}, case
                assert got["flops"] <= ranks[0][case]["flops"], case
                continue
            assert got["calls"] == ranks[0][case]["calls"], case
            assert got["flops"] == ranks[0][case]["flops"], case


def test_collective_terms_convert_each_op():
    """The log's bytes (the last tensor handed to each call) converted to
    the JAX dry run's result bytes, and each group's link."""
    log = [{"op": "psum", "axes": ["model"], "bytes": 100},
           {"op": "pmax", "axes": ["data"], "bytes": 8},
           {"op": "all_gather", "axes": ["data"], "bytes": 64},
           {"op": "reduce_scatter", "axes": ["data"], "bytes": 1600},
           {"op": "all_to_all", "axes": ["model"], "bytes": 48}]
    got = dryrun.collective_terms(log, (16, 16), ("data", "model"))
    assert got["bytes"] == {"all-reduce": 216, "all-gather": 1024,
                            "reduce-scatter": 100, "all-to-all": 48,
                            "collective-permute": 0}
    assert got["calls"]["psum over model"] == {"calls": 1, "bytes": 100}
    assert got["seconds"] == pytest.approx(
        (216 + 1024 + 100 + 48) / dryrun.IB_BW)
    # a model axis of 8 lies in one node of 8 cards: NVLink
    assert dryrun.link_bytes_per_s((4, 8), ("data", "model"),
                                   ("model",)) == dryrun.NVLINK_BW
    assert dryrun.link_bytes_per_s((4, 8), ("data", "model"),
                                   ("data",)) == dryrun.IB_BW
    assert dryrun.group_ranks((2, 16, 16), ("pod", "data", "model"),
                              ("pod",), 17) == [17, 273]


def attention_flops(cfg, sp, grid) -> float:
    """The score and value products a device, which 2 N D leaves out:
    decode ``4 B T`` a head a layer over the whole cache; a training
    step ``3 x 4 B S^2`` (forward and backward, every position against
    every position, as the port computes a causal mask)."""
    sizes = grid.sizes
    b = sp.global_batch // (sizes.get("data", 1) * sizes.get("pod", 1))
    heads = cfg.n_heads // sizes["model"]
    per = 4 * b * heads * cfg.hd * cfg.num_layers
    if sp.kind == "decode":
        return per * sp.seq_len
    return 3 * per * sp.seq_len ** 2


@pytest.mark.parametrize("name", list(FULL))
def test_full_width_cells_count_flops_in_the_band(runs, name):
    code, text, out = runs[0][name]
    assert code == 0, text
    with open(out) as f:
        res = json.load(f)
    arch, shape = FULL[name]
    cfg, sp = get_config(arch), SHAPES[shape]
    grid = make_production_mesh()
    for key in ("arch", "shape", "mesh", "mesh_shape", "chips",
                "useful_flops_ratio"):
        assert key in res
    assert set(res["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                    "dominant", "step_time_s", "mfu_bound"}
    assert res["chips"] == 256 and res["scan_corrected"] is False
    assert res["mesh_shape"] == {"data": 16, "model": 16}
    ratio = res["counted_flops_per_device"] / (
        res["model_flops_per_device"] + attention_flops(cfg, sp, grid))
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio
    assert res["peak_live_bytes_per_device"] > res[
        "state_live_bytes_per_device"] > 0
    assert res["peak_live_bytes_per_device"] < dryrun.HBM_BYTES
    assert res["roofline"]["step_time_s"] == max(
        res["roofline"][k] for k in ("compute_s", "memory_s",
                                     "collective_s"))
    k1 = res["kernel_calls"]["K1 partition_rank"]
    if cfg.is_moe:       # the send pack and regroup, forward and recompute
        assert k1 == 4 * cfg.num_layers
    else:
        assert k1 == 0


def layout_flops(cfg, sp, grid) -> float:
    """The products a device's program computes by its layout, forward
    and backward, without the remat recompute: each matrix's block (the
    whole matrix where its spec replicates it over ``model``, as MLA's
    down projections are) over the device's tokens (a batch of one: its
    row, replicated over the data ranks), 6 FLOPs a weight and token to
    train and 2 to decode; the routed experts at the dense dispatch's
    capacity (a decode step: every local expert's slots for the whole
    batch) or at their active share; the attention's score and value
    products of the device's heads (MLA: the heads it owns, their nope
    and value widths, and the rope score once) over every position or
    a decode step's cache (a sliding window's ring). The norms' scales,
    which no product reads, count nothing, where the model FLOPs count
    each weight. Training and decode cells, not MLA's decode (whose
    keys and values are the whole cache's latents up-projected each
    step)."""
    from repro_torch.models.attention import mla_owned_heads
    from repro_torch.models.layers import param_specs
    from repro_torch.models.registry import meta_params
    assert sp.kind in ("train", "decode")
    assert not (cfg.attn_type == "mla" and sp.kind == "decode")
    sizes = grid.sizes
    m = sizes["model"]
    rows = max(sp.global_batch // (sizes.get("data", 1)
                                   * sizes.get("pod", 1)), 1)
    q = sp.seq_len if sp.kind == "train" else 1
    k = 6 if sp.kind == "train" else 2
    params = meta_params(cfg)
    specs = param_specs(params)
    total = 0.0
    for n, p in params.named_parameters():
        if p.dim() < 2:
            continue
        shards = m if "model" in spec_axes(specs[n]) else 1
        if p.dim() == 3:                     # the routed experts
            if sp.kind == "decode":
                cap = max(int(sp.global_batch * cfg.top_k / cfg.num_experts
                              * cfg.capacity_factor), 1)
                total += 2 * p.shape[0] // shards * cap * p.shape[1] \
                    * p.shape[2]
            else:
                total += k * rows * q * p.numel() / shards * cfg.top_k \
                    / cfg.num_experts
            continue
        total += k * rows * q * p.numel() / shards
    T = sp.seq_len
    if cfg.attn_type == "swa" and sp.kind == "decode":
        T = min(T, cfg.window)
    if cfg.attn_type == "mla":
        heads = len(mla_owned_heads(cfg.n_heads, m, 0))
        per = heads * 2 * (cfg.qk_nope_dim + cfg.v_head_dim) \
            + 2 * cfg.qk_rope_dim
    else:
        per = cfg.n_heads // m * 4 * cfg.hd
    return total + rows * q * T * per * cfg.num_layers * (
        3 if sp.kind == "train" else 1)


@pytest.mark.parametrize("name", list(SPLIT))
def test_split_head_cells_count_flops_in_the_band(runs, name):
    """The cells whose heads split over the 16 model ranks trace, on
    ``(16, 16)`` through the command line: their counted FLOPs lie in
    :data:`FLOP_BAND` over :func:`layout_flops` (above 1: the remat
    recompute; read 1.258 and 1.285 for the training steps, 1.004 and
    1.0 for the decode steps), they fit a card, and the split layouts'
    collectives are there: a GQA layer's keys and values gathered over
    ``model`` (forward and recompute; in the backward a
    ``reduce_scatter``), an MLA layer's twelve exchanges a step."""
    code, text, out = runs[0][name]
    assert code == 0, text
    with open(out) as f:
        res = json.load(f)
    arch, shape = SPLIT[name]
    cfg, sp = get_config(arch), SHAPES[shape]
    assert "roofline" in res and res["mesh_shape"] == {"data": 16,
                                                       "model": 16}
    ratio = res["counted_flops_per_device"] / layout_flops(
        cfg, sp, make_production_mesh())
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio
    assert res["peak_live_bytes_per_device"] < dryrun.HBM_BYTES
    calls = {k: v["calls"] for k, v in res["collective_calls"].items()}
    L, train = cfg.num_layers, sp.kind == "train"
    if cfg.attn_type == "mla":
        assert calls["all_to_all over model"] == 12 * L
    else:
        # serving gathers the logits over model once besides
        assert calls["all_gather over model"] == (2 * L if train
                                                  else L + 1)
        assert calls.get("reduce_scatter over model", 0) == L * train


def test_full_width_moe_step_collectives(runs):
    """Qwen1.5-MoE-A2.7B's step on (16, 16): each MoE layer's 3
    ``all_to_all``s forward and recompute (72), the gradients'
    ZeRO-1 ``reduce_scatter`` and ``all_gather`` a leaf over ``data``."""
    with open(runs[0]["qwen2_moe_a2_7b__train_4k"][2]) as f:
        calls = json.load(f)["collective_calls"]
    assert calls["all_to_all over model"]["calls"] == 72
    assert calls["reduce_scatter over data"]["calls"] == \
        calls["all_gather over data"]["calls"] > 0


def test_cli_writes_both_grids(runs):
    code, text, out = runs[0]["both"]
    assert code == 0, text
    names = sorted(os.listdir(out))
    assert names == ["internvl2_1b__decode_32k__multi.json",
                     "internvl2_1b__decode_32k__single.json"]
    for n in names:
        with open(os.path.join(out, n)) as f:
            res = json.load(f)
        assert "roofline" in res and "error" not in res
    assert "[ok] internvl2_1b__decode_32k__multi" in text
    # a second run reads the cache
    again = _run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                  "internvl2_1b", "--shape", "decode_32k", "--mesh", "both",
                  "--out", out])
    assert again.returncode == 0
    assert again.stdout.count("[skip-cached]") == 2


@pytest.mark.parametrize("arch,shape,reason", [
    ("whisper_small", "train_4k", "encoder frames"),
    ("xlstm_125m", "long_500k", "4 mlstm heads do not split"),
    ("xlstm_125m", "prefill_32k", "4 mlstm heads do not split"),
    ("granite_34b", "long_500k", dryrun.LONG_CONTEXT_SKIP),
    ("tinyllama_1_1b", "long_500k", dryrun.LONG_CONTEXT_SKIP)])
def test_cells_the_port_cannot_run_are_skipped(tmp_path, arch, shape,
                                               reason):
    got = _run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, "--mesh", "both", "--out",
                str(tmp_path)])
    assert got.returncode == 0, got.stdout + got.stderr
    for mesh in ("single", "multi"):
        with open(tmp_path / f"{arch}__{shape}__{mesh}.json") as f:
            res = json.load(f)
        assert reason in res["skipped"]
        assert "error" not in res and "roofline" not in res
        if reason != dryrun.LONG_CONTEXT_SKIP:
            assert dryrun.LAYOUT_WAITS in res["skipped"]


# -- the repairs tracing needed -----------------------------------------------


def _fake_ranks(shape=(2, 2), fake_tensors=True):
    """A fake grid in this process (destroyed when the block ends)."""
    if fake_tensors:
        return dryrun.fake_grid(shape, ("data", "model"))
    import contextlib
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist

    @contextlib.contextmanager
    def grid():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
        try:
            yield ProcessRanks(shape, ("data", "model"), device="cpu")
        finally:
            dist.destroy_process_group()
    return grid()


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "xlstm_125m",
                                  "zamba2_1_2b"])
def test_process_caches_under_fake_tensors(arch):
    """``init_caches(..., ranks=)`` reads each leaf's fill from real
    tensors: under ``FakeTensorMode`` it allocates the blocks."""
    from torch._subclasses.fake_tensor import is_fake
    cfg = dataclasses.replace(get_smoke_config(arch), tp_size=2)
    model = build(cfg)
    with _fake_ranks() as ranks:
        caches = model.init_caches(4, 16, ranks=ranks, dp_axes=("data",))
        leaves = [t for t in torch.utils._pytree.tree_leaves(caches)
                  if isinstance(t, torch.Tensor)]
        assert leaves and all(is_fake(t) for t in leaves)
    # the same blocks as real tensors, filled as init_caches fills them
    with _fake_ranks(fake_tensors=False) as ranks:
        real = model.init_caches(4, 16, ranks=ranks, dp_axes=("data",))
    shapes = lambda tree: [tuple(t.shape) for t in  # noqa: E731
                           torch.utils._pytree.tree_leaves(tree)
                           if isinstance(t, torch.Tensor)]
    assert shapes(caches) == shapes(real)


def test_fake_backend_takes_host_tensors_over_a_sub_group():
    with _fake_ranks(fake_tensors=False) as ranks:
        assert ranks.backend == "fake"
        assert ranks.host_group() is None
        assert ranks._group(("model",), host=True) is ranks._groups[
            ("model",)]
        x = torch.ones(1, 3)
        assert ranks.psum(x, "model").shape == (1, 3)
        assert ranks.all_gather(x, "data").shape == (1, 6)


def test_log_of_fake_tensors_neither_synchronises_nor_times(monkeypatch):
    """A traced call is logged with its op, axes and bytes, and never
    synchronises a card (even a grid on ``cuda``) or reads a clock."""
    import time as time_mod
    from repro_torch import comm
    synced, timed = [], []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: synced.append(1))
    real_clock = time_mod.perf_counter
    with dryrun.fake_grid((2, 2), ("data", "model")) as ranks:
        ranks.device = torch.device("cuda")       # as a grid on the card
        monkeypatch.setattr(comm.time, "perf_counter",
                            lambda: timed.append(1) or real_clock())
        ranks.log = []
        ranks.psum(torch.ones(1, 4, 8), "model")
        ranks.reduce_scatter(torch.ones(1, 4, 8), "data")
        monkeypatch.undo()
    assert not synced and not timed
    assert ranks.log == [
        {"op": "psum", "axes": ["model"], "bytes": 4 * 8 * 4,
         "seconds": 0.0},
        {"op": "reduce_scatter", "axes": ["data"], "bytes": 4 * 8 * 4,
         "seconds": 0.0}]
