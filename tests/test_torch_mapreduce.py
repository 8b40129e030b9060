"""The port's MapReduce, streams and segment UDFs against the JAX package.

One-rank functions (``default_hash``, ``reduce_by_key_sum``,
``plan_segments``, ``micro_batches``) are compared in-process; the
multi-device ones (the wordcount Dataflow on the flat ranks and on the
``(dc, node)`` grid, the ``map_reduce`` shim, ``sphere_map``) against the
references of the one subprocess of ``tests/test_torch_jax_refs.py``. The
same numpy inputs go to both packages. Integers, masks, drop counts and
float sums are compared exactly (both packages sum each float run on its
own, in the value dtype).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapreduce as jmr
from repro.core.stream import SphereStream as JSphereStream
from repro_torch import interop
from repro_torch.comm import Ranks
from repro_torch.core.mapreduce import (default_hash, map_reduce,
                                        reduce_by_key_sum)
from repro_torch.core.stream import SphereStream, make_stream
from repro_torch.core.udf import sphere_map
from repro_torch.kernels import radix_sort
from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

from test_torch_jax_refs import (N_WORDS, VOCAB, WORDCOUNT_SRC,
                                 jax_references, shuffle_inputs,
                                 word_inputs)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return jax_references(tmp_path_factory)


# -- one rank, in-process --------------------------------------------------------


def test_default_hash_equals_jax_on_edge_and_random_keys():
    rng = np.random.default_rng(1)
    keys = np.concatenate([
        np.array([0, 1, -1, 2**31 - 1, -2**31, 65535, 65536, -65536],
                 np.int32),
        rng.integers(-2**31, 2**31 - 1, size=5000).astype(np.int32)])
    for nb in (1, 2, 7, 8, 16, 1000, 65537):
        got = default_hash(torch.from_numpy(keys), nb)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jmr.default_hash(jnp.asarray(keys), nb)))


def _jax_rbks(keys, values, valid, **kw):
    return [np.asarray(a) for a in jmr.reduce_by_key_sum(
        jnp.asarray(keys), jnp.asarray(values), jnp.asarray(valid),
        algo="oracle", **kw)]


@pytest.mark.parametrize("algo", ["radix", "bitonic", "oracle"])
@pytest.mark.parametrize("n,vocab,max_unique", [
    (8, 10, 3), (8, 10, None), (1000, 50, None), (1000, 900, 100),
    (4096, 4096, None), (1, 2, None)])
def test_reduce_by_key_sum_matches_jax(algo, n, vocab, max_unique):
    rng = np.random.default_rng(n + vocab)
    keys = rng.integers(0, vocab, size=n).astype(np.int32)
    values = rng.integers(-5, 100, size=n).astype(np.int32)
    valid = rng.random(n) > 0.1
    want_k, want_v, want_d = _jax_rbks(keys, values, valid,
                                       max_unique=max_unique)
    got_k, got_v, got_d = reduce_by_key_sum(
        torch.from_numpy(keys), torch.from_numpy(values),
        torch.from_numpy(valid), max_unique=max_unique, algo=algo)
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert int(got_d) == int(want_d)


def test_reduce_by_key_sum_reports_truncation_drops():
    """``tests/test_dataflow.py:149-161`` on the port."""
    keys = torch.tensor([5, 1, 5, 2, 3, 4, 1, 9], dtype=torch.int32)
    values = torch.ones_like(keys)
    valid = torch.ones(8, dtype=torch.bool)
    out_k, out_v, dropped = reduce_by_key_sum(keys, values, valid,
                                              max_unique=3)
    assert int(dropped) == 3 and int((out_k >= 0).sum()) == 3
    out_k, out_v, dropped = reduce_by_key_sum(keys, values, valid)
    assert int(dropped) == 0
    got = {int(k): int(v) for k, v in zip(out_k, out_v) if k >= 0}
    assert got == {1: 2, 2: 1, 3: 1, 4: 1, 5: 2, 9: 1}


def test_reduce_by_key_sum_stacked_rows_and_float_values():
    """The stacked form sorts every rank in one call and equals the JAX
    function row by row; float values keep their dtype."""
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 40, size=(3, 300)).astype(np.int32)
    values = rng.standard_normal((3, 300)).astype(np.float32)
    valid = rng.random((3, 300)) > 0.2
    before = radix_sort.KERNEL.launches
    got_k, got_v, got_d = reduce_by_key_sum(
        torch.from_numpy(keys), torch.from_numpy(values),
        torch.from_numpy(valid), max_unique=30, algo="radix")
    assert radix_sort.KERNEL.launches == before    # CPU: the plain version
    assert got_v.dtype == torch.float32 and got_d.shape == (3,)
    for r in range(3):
        want_k, want_v, want_d = _jax_rbks(keys[r], values[r], valid[r],
                                           max_unique=30)
        np.testing.assert_array_equal(got_k[r].numpy(), want_k)
        np.testing.assert_array_equal(got_v[r].numpy(), want_v)
        assert int(got_d[r]) == int(want_d)


def _mixed_magnitude_rows(dtype):
    """Three rows of mixed magnitudes: the repro ``[1e20, 1, 3]``; a row
    that starts with 1e20 and goes on with small runs; and a row whose
    runs continue the previous row's keys (runs across rank boundaries).
    Small values are multiples of 1/4, so every run's sum is exact in any
    order."""
    rng = np.random.default_rng(31)
    n = 64
    keys = np.zeros((3, n), np.int32)
    vals = np.zeros((3, n), dtype)
    keys[0, :3] = [0, 1, 2]
    vals[0, :3] = [1e20, 1, 3]
    keys[0, 3:] = 7                       # 61 more of one small run
    vals[0, 3:] = rng.integers(-8, 9, n - 3) / 4
    keys[1] = np.sort(rng.integers(0, 9, n))
    keys[1, 0] = 0
    vals[1] = rng.integers(-8, 9, n) / 4
    vals[1, 0] = -1e20 if dtype == np.float64 else -3e38
    keys[2] = np.sort(rng.integers(5, 12, n))
    vals[2] = rng.integers(-8, 9, n) / 4
    valid = np.ones((3, n), bool)
    valid[2, ::5] = False
    return keys, vals, valid


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("algo", ["radix", "oracle"])
def test_reduce_by_key_sum_mixed_magnitude_floats_match_jax(dtype, algo):
    """A float run's total must not depend on the runs before it, in its
    row or in earlier rows (the port once took totals as differences of
    prefix sums over the whole buffer and lost [1, 3] after 1e20)."""
    keys, vals, valid = _mixed_magnitude_rows(dtype)
    got_k, got_v, got_d = reduce_by_key_sum(
        torch.from_numpy(keys[:1, :3]), torch.from_numpy(vals[:1, :3]),
        torch.from_numpy(valid[:1, :3]), algo=algo)
    np.testing.assert_array_equal(got_k[0].numpy(), [0, 1, 2])
    np.testing.assert_array_equal(got_v[0].numpy(),
                                  np.asarray([1e20, 1, 3], dtype))
    got_k, got_v, got_d = reduce_by_key_sum(
        torch.from_numpy(keys), torch.from_numpy(vals),
        torch.from_numpy(valid), algo=algo)
    assert got_v.dtype == torch.from_numpy(vals).dtype
    with jax.enable_x64(dtype == np.float64):
        for r in range(3):
            want_k, want_v, want_d = _jax_rbks(keys[r], vals[r], valid[r])
            assert want_v.dtype == dtype
            np.testing.assert_array_equal(got_k[r].numpy(), want_k)
            np.testing.assert_array_equal(got_v[r].numpy(), want_v)
            assert int(got_d[r]) == int(want_d)
        want = _jax_rbks(keys[0, :3], vals[0, :3], valid[0, :3])
    np.testing.assert_array_equal(want[1], np.asarray([1e20, 1, 3], dtype))


def test_plan_segments_matches_jax():
    files = [("/a", 1000), ("/b", 7), ("/c", 0), ("/d", 12345)]
    for total, rb, s_min, s_max, spes in ((13352, 100, 800, 64000, 4),
                                          (13352, 10, 8 << 20, 128 << 20, 1),
                                          (13352, 1, 1, 50, 16), (0, 8, 1, 2,
                                                                 3)):
        got = SphereStream.plan_segments(total, rb, files, s_min, s_max, spes)
        want = JSphereStream.plan_segments(total, rb, files, s_min, s_max,
                                           spes)
        assert [dataclasses.astuple(s) for s in got] == \
            [dataclasses.astuple(s) for s in want]


def test_micro_batches_match_jax():
    data, _, valid = shuffle_inputs()
    tree = {"x": data, "y": data[:, 0].astype(np.float64)}
    want = list(JSphereStream(data=tree, valid=valid).micro_batches(300))
    ranks = Ranks(8, device="cpu")
    for stream in (SphereStream(data=tree, valid=valid),
                   SphereStream(data=tree, valid=valid).shard(ranks)):
        got = list(stream.micro_batches(300))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in ("x", "y"):
                np.testing.assert_array_equal(g[k], w[k])
    short = list(SphereStream(data=data).micro_batches(1000,
                                                        drop_remainder=True))
    assert [b.shape[0] for b in short] == [1000] * 4
    with pytest.raises(ValueError):
        next(SphereStream(data=data).micro_batches(0))


# -- several ranks, against the subprocess' references ----------------------------


def _wordcount(ranks, algo):
    df = eval(WORDCOUNT_SRC, {"Dataflow": Dataflow,
                              "default_hash": default_hash,
                              "reduce_by_key_sum": reduce_by_key_sum,
                              "ALGO": algo})
    words = word_inputs()
    return words, SPMDExecutor(ranks).run(
        df, {"word": interop.to_ranks(words, ranks)})


@pytest.mark.parametrize("grid", ["flat", "hier"])
@pytest.mark.parametrize("algo", ["radix", "bitonic"])
def test_wordcount_dataflow_matches_jax_and_bincount(jax_ref, grid, algo):
    ranks = (Ranks(8, device="cpu") if grid == "flat" else
             Ranks(shape=(2, 4), axes=("dc", "node"), device="cpu"))
    words, res = _wordcount(ranks, algo)
    tag = f"wc_{grid}"
    valid = interop.to_global(res.valid)
    keys = interop.to_global(res.records["key"])
    counts = interop.to_global(res.records["value"])
    np.testing.assert_array_equal(valid, jax_ref[f"{tag}_valid"])
    np.testing.assert_array_equal(keys, jax_ref[f"{tag}_key"])
    np.testing.assert_array_equal(counts, jax_ref[f"{tag}_value"])
    assert int(res.dropped) == int(jax_ref[f"{tag}_dropped"]) == 0
    want = np.bincount(words, minlength=VOCAB)
    got = np.zeros(VOCAB, np.int64)
    np.add.at(got, keys[valid], counts[valid])
    np.testing.assert_array_equal(got, want)
    assert int(valid.sum()) == int((want > 0).sum())   # one row per word
    assert counts[valid].sum() == N_WORDS


def test_map_reduce_shim_matches_jax(jax_ref):
    ranks = Ranks(8, device="cpu")
    k, v, valid, dropped = map_reduce(
        lambda seg: (seg % 300, seg * 0 + 1),
        lambda k, v, ok: reduce_by_key_sum(k, v, ok, max_unique=20,
                                           algo="radix"),
        interop.to_ranks(word_inputs(), ranks), ranks, num_buckets=8)
    np.testing.assert_array_equal(interop.to_global(valid), jax_ref["mr_valid"])
    np.testing.assert_array_equal(interop.to_global(k), jax_ref["mr_key"])
    np.testing.assert_array_equal(interop.to_global(v), jax_ref["mr_value"])
    assert int(dropped) == int(jax_ref["mr_dropped"]) > 0


def test_sphere_map_matches_jax(jax_ref):
    data, _, valid = shuffle_inputs()
    ranks = Ranks(8, device="cpu")
    st = dataclasses.replace(make_stream(data), valid=valid).shard(ranks)
    r1 = sphere_map(lambda x: x * 2 + 1, st, ranks)
    np.testing.assert_array_equal(interop.to_global(r1.data),
                                  jax_ref["smap_rec"])
    np.testing.assert_array_equal(interop.to_global(r1.valid),
                                  jax_ref["smap_rec_valid"])
    r2 = sphere_map(lambda x: x.sum(dim=0, keepdim=True), st, ranks)
    np.testing.assert_array_equal(interop.to_global(r2.data),
                                  jax_ref["smap_seg"])
    assert (r2.valid is None) == bool(jax_ref["smap_seg_valid"])
    r3 = sphere_map(lambda a, b: a - b[:, :1],
                    [st, make_stream(data * 5, ranks)], ranks)
    np.testing.assert_array_equal(interop.to_global(r3.data),
                                  jax_ref["smap_two"])
    r4 = sphere_map(lambda x: x[:2] * 0 + 7, st, ranks, out_axis=None)
    np.testing.assert_array_equal(r4.data.numpy(), jax_ref["smap_rep"])
    with pytest.raises(ValueError):
        sphere_map(lambda x: x, st, ranks, out_axis="other")
