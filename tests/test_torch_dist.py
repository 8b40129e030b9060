"""``ProcessRanks`` (one rank a process, ``torch.distributed`` over CPU
gloo) against the stacked ``Ranks``, on the same seeded inputs.

One spawn of 4 processes runs every path (``tests/torch_dist_paths.py``)
on the grids ``(4,)`` ``("data",)``, ``(2, 2)`` ``("dc", "node")`` and
``(1, 4)`` ``("data", "model")``, with a hard ``timeout_s`` of its own, so
that a hung rendezvous fails these tests and no other. Each process
returns its own row; the rows, in rank order, must equal the stacked
backend's rows. Tolerances:

- collectives, sorts, the wordcount and the stream: exact (integer data,
  or the same float32 inputs summed over four ranks — ``psum_f32`` is
  held to 1e-6 relative, as gloo's ring and the stacked ``sum`` add in
  other orders);
- the MoE layer: routing, per-expert counts and ``moe_dropped`` exact;
  the output within one bfloat16 ulp of the stacked one's largest value
  (2^-7 relative), as the experts' batched products run over 4 experts a
  process instead of 16; ``moe_aux`` within 1e-6 relative (the mean over
  the expert ranks is a gloo ``psum``).

Collective counts per process equal the stacked backend's, but for the
MoE layer, whose ``moe_aux`` mean is one ``psum`` more on processes (the
JAX package's ``pmean``).

Where the JAX package's shared 8-device subprocess
(``tests/test_torch_jax_refs.py``) holds results for the same inputs, the
global outputs are held to it too: the flat sort's keys and payload, the
``(dc, node)`` record sort's keys and values, and the wordcount's (word,
count) pairs, which do not depend on the rank count.
"""

import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.comm import (ProcessRanks, Ranks, free_port,
                              resolve_device, spawn_ranks)
from repro_torch.configs.base import get_smoke_config
import torch_dist_paths as paths
from test_torch_jax_refs import (jax_references, terasort_inputs,
                                 word_inputs)

WORLD = 4
GRIDS = {"flat": ((4,), ("data",)), "grid": ((2, 2), ("dc", "node")),
         "moe": ((1, 4), ("data", "model"))}
N_BYTES = 8 * 1024
#: one stream micro-batch and the carry's rows a rank
MICRO, CARRY = 2048, 512


def _moe_inputs():
    cfg = paths.moe_config(get_smoke_config("qwen2_moe_a2_7b"))
    x = np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    return cfg, torch.from_numpy(x).to(torch.bfloat16)


def _inputs():
    keys, payload, value = terasort_inputs()
    words = word_inputs()
    cfg, x = _moe_inputs()
    return {"keys": keys, "payload": payload, "value": value,
            "words": words, "cfg": cfg, "x": x}


def _all_paths(ranks, inputs):
    """Every path, in one process of the spawn (``ranks``: its ``(4,)``
    grid). The other grids are built over the same process group."""
    grids = {"flat": ranks,
             "grid": ProcessRanks(*GRIDS["grid"], device="cpu"),
             "moe": ProcessRanks(*GRIDS["moe"], device="cpu")}
    out = _run(grids, inputs)
    grids["grid"].log = []
    grids["grid"].psum(grids["grid"].stack(torch.ones((WORLD, 3),
                                                      dtype=torch.int32)),
                       "node")
    out["log"] = grids["grid"].log
    return out


def _run(grids, inputs):
    """The paths on ``grids`` (fresh grids: their counts start at 0)."""
    k, p, v = inputs["keys"], inputs["payload"], inputs["value"]
    out = {"collectives": {name: paths.collectives(g)
                           for name, g in grids.items()}}
    for g in grids.values():
        g.collectives.clear()
    out["terasort"] = paths.flat_terasort(grids["flat"], k, p)
    grids["flat"].collectives.clear()
    out["record_sort_grid"] = paths.record_sort(
        grids["grid"], k[:N_BYTES], v, axes=("dc", "node"))
    out["wordcount"] = paths.wordcount(grids["flat"], inputs["words"])
    grids["flat"].collectives.clear()
    out["stream"] = paths.stream_batches(grids["flat"], inputs["words"],
                                         MICRO, CARRY)
    out["moe"] = paths.moe_layer(grids["moe"], inputs["cfg"], inputs["x"])
    return out


def _stacked_grids():
    return {name: Ranks(shape=s, axes=a, device="cpu")
            for name, (s, a) in GRIDS.items()}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def spawned(inputs):
    t0 = time.perf_counter()
    res = spawn_ranks(_all_paths, (WORLD,), device="cpu", timeout_s=150,
                      args=(inputs,))
    return res, time.perf_counter() - t0


@pytest.fixture(scope="module")
def stacked(inputs):
    return _run(_stacked_grids(), inputs)


def _rows(results, *path):
    """Each process's value at ``path``, concatenated in rank order."""
    vals = []
    for r in results:
        for key in path:
            r = r[key]
        vals.append(r)
    return torch.cat(vals)


def _same(results, *path):
    vals = []
    for r in results:
        for key in path:
            r = r[key]
        vals.append(r)
    return vals


# -- the collectives ----------------------------------------------------------


COLLECTIVE_CASES = [(g, op) for g in GRIDS for op in (
    "all_to_all", "psum", "psum_f32", "all_gather", "axis_index",
    "all_to_all_a0", "all_to_all_a1", "psum_a0", "psum_a1",
    "axis_index_a0", "axis_index_a1", "axis_index_rev", "psum_all_named")
    if len(GRIDS[g][0]) > 1 or not op.endswith(("a1", "rev", "named"))]


@pytest.mark.parametrize("grid,op", COLLECTIVE_CASES,
                         ids=[f"{g}-{o}" for g, o in COLLECTIVE_CASES])
def test_collective_equals_stacked(spawned, stacked, grid, op):
    """Rows gathered in rank order equal the stacked rows; a sum over
    every axis is the one unstacked value on every process."""
    results, _ = spawned
    axes = GRIDS[grid][1]
    key = op
    for i, a in enumerate(axes):
        key = key.replace(f"_a{i}", f"_{a}")
    want = stacked["collectives"][grid][key]
    everywhere = ("psum", "psum_f32", "all_gather", "psum_all_named")
    if op in everywhere or (op == "psum_a0" and len(axes) == 1):
        for got in _same(results, "collectives", grid, key):
            assert (got.shape, got.dtype) == (want.shape, want.dtype)
            if op == "psum_f32":
                torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
            else:
                assert torch.equal(got, want)
    else:
        got = _rows(results, "collectives", grid, key)
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_collective_counts_equal_stacked(spawned, stacked, grid):
    results, _ = spawned
    want = stacked["collectives"][grid]["counts"]
    assert all(c == want for c in _same(results, "collectives", grid,
                                        "counts"))


# -- the sorts, the wordcount, the stream -------------------------------------


def test_flat_terasort_equals_stacked_and_jax(spawned, stacked,
                                              tmp_path_factory):
    results, _ = spawned
    want = stacked["terasort"]
    for f in ("keys", "valid"):
        assert torch.equal(_rows(results, "terasort", f), want[f])
    valid = want["valid"]
    got_p = _rows(results, "terasort", "payload")
    # K3 is unstable: equal keys may hold their payloads in another order
    pairs = lambda k, p: sorted(zip(k.tolist(), p.tolist()))   # noqa: E731
    assert pairs(want["keys"][valid], got_p[valid]) == pairs(
        want["keys"][valid], want["payload"][valid])
    assert all(int(d) == 0 for d in _same(results, "terasort", "dropped"))
    assert all(c == want["counts"]
               for c in _same(results, "terasort", "counts"))
    refs = jax_references(tmp_path_factory)
    jk, jv = refs["bitonic_keys"], refs["bitonic_valid"]
    assert np.array_equal(want["keys"][valid].numpy(), jk[jv])
    assert pairs(torch.from_numpy(jk[jv]), torch.from_numpy(
        refs["bitonic_payload"][jv])) == pairs(want["keys"][valid],
                                               got_p[valid])


def test_grid_record_sort_equals_stacked_and_jax(spawned, stacked,
                                                 tmp_path_factory):
    """The ``(dc, node)`` hierarchical sort of 100-byte records."""
    results, _ = spawned
    want = stacked["record_sort_grid"]
    for f in ("key", "valid"):
        assert torch.equal(_rows(results, "record_sort_grid", f), want[f])
    valid = want["valid"]
    got_v = _rows(results, "record_sort_grid", "value")[valid]
    key = want["key"][valid]

    def multiset(k, v):
        return sorted(zip(k.tolist(), map(bytes, v.numpy())))
    assert multiset(key, got_v) == multiset(key, want["value"][valid])
    assert all(c == want["counts"]
               for c in _same(results, "record_sort_grid", "counts"))
    assert want["counts"]["all_to_all"] == 2
    refs = jax_references(tmp_path_factory)
    jv = refs["hbytes_valid"]
    assert np.array_equal(key.numpy(), refs["hbytes_key"][jv])
    assert multiset(key, got_v) == multiset(
        torch.from_numpy(refs["hbytes_key"][jv]),
        torch.from_numpy(refs["hbytes_value"][jv]))


def test_wordcount_equals_stacked_and_jax(spawned, stacked,
                                          tmp_path_factory):
    results, _ = spawned
    want = stacked["wordcount"]
    for f in ("key", "value", "valid"):
        assert torch.equal(_rows(results, "wordcount", f), want[f])
    assert all(c == want["counts"]
               for c in _same(results, "wordcount", "counts"))
    refs = jax_references(tmp_path_factory)
    jv = refs["wc_flat_valid"]
    valid = want["valid"]
    assert sorted(zip(want["key"][valid].tolist(),
                      want["value"][valid].tolist())) == sorted(
        zip(refs["wc_flat_key"][jv].tolist(),
            refs["wc_flat_value"][jv].tolist()))


def test_stream_batches_equal_stacked(spawned, stacked):
    """Two carried micro-batches: each batch's rows, its drops and the
    carry after it."""
    results, _ = spawned
    want = stacked["stream"]
    for i in range(2):
        for f in ("key", "value", "valid"):
            assert torch.equal(_rows(results, "stream", f"batch{i}", f),
                               want[f"batch{i}"][f])
        assert all(d == want[f"dropped{i}"]
                   for d in _same(results, "stream", f"dropped{i}"))
        for f in ("key", "value"):
            got = np.concatenate([np.asarray(c[f]) for c in _same(
                results, "stream", f"carry{i}")])
            assert np.array_equal(got, np.asarray(want[f"carry{i}"][f]))
    assert all(c == want["counts"] for c in _same(results, "stream",
                                                  "counts"))


# -- the MoE layer ------------------------------------------------------------


def test_moe_layer_holds_to_the_stacked_dispatch(spawned, stacked):
    """Each process's block of the output, routing and per-expert counts
    against the stacked layer's on the same weights and input."""
    results, _ = spawned
    want = stacked["moe"]
    cfg, x = _moe_inputs()
    b, s, d = x.shape
    cols = WORLD
    k = cfg.top_k
    top = want["top_i"].reshape(b, s, k)
    per_expert = torch.zeros_like(want["per_expert"])
    scale = want["out"].float().abs().max().item()
    for rank, r in enumerate(results):
        c = rank % cols
        sl = (slice(None), slice(c * (s // cols), (c + 1) * (s // cols)))
        assert torch.equal(r["moe"]["top_i"], top[sl].reshape(-1, k))
        torch.testing.assert_close(r["moe"]["out"].float(),
                                   want["out"][sl].float(), rtol=0,
                                   atol=scale * 2 ** -7)
        assert int(r["moe"]["dropped"]) == int(want["dropped"])
        torch.testing.assert_close(r["moe"]["aux"], want["aux"], rtol=1e-6,
                                   atol=0)
        per_expert += r["moe"]["per_expert"]
        counts = dict(want["counts"])
        counts["psum"] += 1
        assert r["moe"]["counts"] == counts
    assert torch.equal(per_expert, want["per_expert"])


# -- the launcher and the transport's rules -----------------------------------


def test_the_collective_log_records_each_call(spawned):
    """``ProcessRanks.log``: one entry a call, with the bytes handed to the
    transport (three int32 counts widened to int64) and its seconds."""
    results, _ = spawned
    for r in results:
        (entry,) = r["log"]
        assert (entry["op"], entry["axes"], entry["bytes"]) == (
            "psum", ["node"], 3 * 8)
        assert 0 <= entry["seconds"] < 30


def test_a_rank_never_builds_the_kernels(monkeypatch):
    """With ``REPRO_KERNELS_PREBUILT=1`` (what every spawned rank runs
    under) a missing library raises instead of starting ``nvcc``."""
    from repro_torch.kernels import build
    monkeypatch.setenv(build.PREBUILT_ENV, "1")
    monkeypatch.setattr(build, "nvcc_path", lambda: pytest.fail("nvcc"))
    if build.library_path("partition").exists():
        build.build_all(["partition"])
    else:
        with pytest.raises(RuntimeError, match="may not build"):
            build.build_all(["partition"])


def test_spawn_is_inside_its_limit(spawned):
    _, seconds = spawned
    assert seconds < 150


def _raise(ranks):
    if ranks.rank == 1:
        raise ValueError("rank one fails on purpose")
    ranks.psum(ranks.stack(torch.zeros((ranks.world, 1))))
    return ranks.rank


def _sleep(ranks):
    time.sleep(60)


def test_a_failing_rank_fails_the_spawn():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        spawn_ranks(_raise, (2,), device="cpu", timeout_s=60)
    assert time.perf_counter() - t0 < 60


def test_a_rank_that_overruns_is_killed():
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        spawn_ranks(_sleep, (2,), device="cpu", timeout_s=3)
    assert time.perf_counter() - t0 < 30


def test_spawn_without_a_card_raises_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            spawn_ranks(_raise, (2,), device=device)


def test_nccl_with_fewer_cards_than_ranks_raises():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="one card a rank"):
        spawn_ranks(_raise, (n + 1,), backend="nccl", device="cpu")


def test_process_ranks_on_cuda_without_a_card_raises():
    """In a process group of one: ``device="cuda"`` (or the default) with
    no card raises; ``"cpu"`` builds; a grid of another size raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="process group"):
        ProcessRanks((1,))
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="cuda"):
                ProcessRanks((1,), device=device)
        with pytest.raises(ValueError, match="backend"):
            ProcessRanks((1,), backend="nccl", device="cpu")
        with pytest.raises(ValueError, match="process group"):
            ProcessRanks((2,), device="cpu")
        r = ProcessRanks((1,), device="cpu")
        assert (r.rows, r.world, r.rank, r.device) == (1, 1, 0,
                                                       resolve_device("cpu"))
    finally:
        dist.destroy_process_group()


def test_from_env_joins_a_torchrun_launch(monkeypatch):
    """``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` as
    ``torchrun`` sets them, for a world of one; the grid defaults to one
    ``data`` axis over it."""
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"),
                 ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(free_port()))):
        monkeypatch.setenv(k, v)
    r = ProcessRanks.from_env(device="cpu", timeout_s=30)
    try:
        assert (r.shape, r.axes, r.rank, r.backend) == ((1,), ("data",), 0,
                                                         "gloo")
        x = torch.arange(6, dtype=torch.int32).reshape(1, 1, 6)
        assert torch.equal(r.psum(x), x[0])
        assert torch.equal(r.all_to_all(x), x)
    finally:
        dist.destroy_process_group()
