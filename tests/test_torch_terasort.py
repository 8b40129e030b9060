"""The whole slice: Terasort through the port's SPMD dataflow on 8 stacked
CPU ranks, against the JAX package on 8 virtual CPU devices.

The subprocess of ``tests/test_torch_jax_refs.py`` runs every JAX
reference (Auto-axis mesh from ``repro.compat.make_mesh``) on the keys of
``tests/test_spmd.py:35`` and writes them to an ``.npz``; each test runs
the port on the same numpy inputs. Keys, valid masks and drop counts must
be equal exactly; with the unstable bitonic sort the (key, payload)
multiset per rank must be equal, with the stable radix sort the payload
too.
"""

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.comm import Ranks
from repro_torch.core.sort import (hadoop_style_sort, is_globally_sorted,
                                   terasort, uniform_splitters)
from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

from test_torch_jax_refs import (MSR_SRC, N, N_BYTES, N_RADIX,
                                 jax_references, terasort_inputs)

@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return jax_references(tmp_path_factory)


def _ranks():
    return Ranks(8, device="cpu")


def _check_against(res, ref, tag, keys, stable):
    g = interop.sort_result_to_global(res)
    np.testing.assert_array_equal(g["valid"], ref[f"{tag}_valid"])
    np.testing.assert_array_equal(g["keys"][g["valid"]],
                                  ref[f"{tag}_keys"][ref[f"{tag}_valid"]])
    assert int(g["dropped"]) == int(ref[f"{tag}_dropped"]) == 0
    assert is_globally_sorted(res, 8)
    vk, vp = g["keys"][g["valid"]], g["payload"][g["valid"]]
    assert (keys[vp] == vk).all()                     # payload beside its key
    per = g["valid"].shape[0] // 8
    for r in range(8):
        sl = slice(r * per, (r + 1) * per)
        mine, theirs = g["valid"][sl], ref[f"{tag}_valid"][sl]
        got = list(zip(g["keys"][sl][mine], g["payload"][sl][mine]))
        want = list(zip(ref[f"{tag}_keys"][sl][theirs],
                        ref[f"{tag}_payload"][sl][theirs]))
        if stable:
            assert got == want
        else:
            assert sorted(got) == sorted(want)


def test_terasort_bitonic_matches_jax(jax_ref):
    keys, payload, _ = terasort_inputs()
    rk = _ranks()
    res = terasort(interop.to_ranks(keys, rk), interop.to_ranks(payload, rk),
                   rk)
    _check_against(res, jax_ref, "bitonic", keys, stable=False)


def test_terasort_buckets_per_device_4_matches_jax(jax_ref):
    keys, payload, _ = terasort_inputs()
    rk = _ranks()
    res = terasort(interop.to_ranks(keys, rk), interop.to_ranks(payload, rk),
                   rk, buckets_per_device=4)
    _check_against(res, jax_ref, "bpd4", keys, stable=False)


def test_terasort_radix_matches_jax_exactly(jax_ref):
    keys, payload, _ = terasort_inputs()
    keys, payload = keys[:N_RADIX], payload[:N_RADIX]
    rk = _ranks()
    res = terasort(interop.to_ranks(keys, rk), interop.to_ranks(payload, rk),
                   rk, sort_algo="radix")
    _check_against(res, jax_ref, "radix", keys, stable=True)
    g = interop.sort_result_to_global(res)
    np.testing.assert_array_equal(g["payload"][g["valid"]],
                                  jax_ref["radix_payload"][jax_ref["radix_valid"]])


def test_hadoop_style_sort_equals_terasort_and_jax(jax_ref):
    keys, payload, _ = terasort_inputs()
    keys, payload = keys[:N_RADIX], payload[:N_RADIX]
    rk = _ranks()
    kt, pt = interop.to_ranks(keys, rk), interop.to_ranks(payload, rk)
    a = interop.sort_result_to_global(terasort(kt, pt, rk))
    b = interop.sort_result_to_global(hadoop_style_sort(kt, pt, rk))
    np.testing.assert_array_equal(a["keys"][a["valid"]], b["keys"][b["valid"]])
    np.testing.assert_array_equal(
        b["keys"][b["valid"]], jax_ref["hadoop_keys"][jax_ref["hadoop_valid"]])
    assert (keys[b["payload"][b["valid"]]] == b["keys"][b["valid"]]).all()


def test_dataflow_sort_100_byte_records_matches_jax(jax_ref):
    keys, _, value = terasort_inputs()
    rk = _ranks()
    records = interop.records_to_ranks({"key": keys[:N_BYTES],
                                        "value": value}, rk)
    df = Dataflow.source().sort(key=lambda r: r["key"], num_buckets=8)
    ex = SPMDExecutor(rk, sort_algo="bitonic")
    res = ex.run(df, records)
    valid = interop.to_global(res.valid)
    out_k = interop.to_global(res.records["key"])
    out_v = interop.to_global(res.records["value"])
    np.testing.assert_array_equal(valid, jax_ref["bytes_valid"])
    np.testing.assert_array_equal(out_k[valid],
                                  jax_ref["bytes_key"][jax_ref["bytes_valid"]])
    assert int(res.dropped) == int(jax_ref["bytes_dropped"]) == 0
    per = valid.shape[0] // 8
    for r in range(8):
        sl = slice(r * per, (r + 1) * per)
        got = sorted(zip(out_k[sl][valid[sl]].tolist(),
                         map(bytes, out_v[sl][valid[sl]])))
        want = sorted(zip(jax_ref["bytes_key"][sl][jax_ref["bytes_valid"][sl]]
                          .tolist(),
                          map(bytes, jax_ref["bytes_value"][sl]
                              [jax_ref["bytes_valid"][sl]])))
        assert got == want
    # rerunning the same pipeline object replays the cached plan
    ex.run(df, records)
    info = ex.cache_info()
    assert (info.hits, info.misses, info.currsize) == (1, 1, 1)


def test_sentinel_guard_raises_for_bitonic_not_radix(jax_ref):
    keys, payload, _ = terasort_inputs()
    kmax = keys[:N_RADIX].copy()
    kmax[::97] = np.iinfo(np.int32).max
    rk = _ranks()
    kt, pt = interop.to_ranks(kmax, rk), interop.to_ranks(payload[:N_RADIX], rk)
    assert bool(jax_ref["guard_bitonic"])
    with pytest.raises(ValueError, match="sentinel"):
        terasort(kt, pt, rk, use_pallas=True)
    res = terasort(kt, pt, rk, sort_algo="radix")
    _check_against(res, jax_ref, "guard_radix", kmax, stable=True)


def test_uniform_splitters_match_jax_in_float32():
    """Every bucket count 2..1024 on (0, INT32_MAX): the linspaces of one
    jitted program with the bounds as arguments (as an eager
    ``jnp.linspace`` compiles them), and the JAX package's own
    ``uniform_splitters`` called eagerly at non-powers of two."""
    import jax
    import jax.numpy as jnp
    from repro.core.sort import uniform_splitters as juniform
    counts = range(2, 1025)
    ref = jax.jit(lambda lo, hi: [
        jnp.linspace(lo, hi, nb + 1)[1:-1].astype(jnp.int32)
        for nb in counts])(0, np.iinfo(np.int32).max)
    for nb, want in zip(counts, ref):
        np.testing.assert_array_equal(
            uniform_splitters(nb, device="cpu").numpy(), np.asarray(want),
            err_msg=f"nb={nb}")
    for nb in (3, 6, 7, 24, 96, 100, 255, 513, 1000, 1023):
        np.testing.assert_array_equal(
            uniform_splitters(nb, device="cpu").numpy(),
            np.asarray(juniform(nb)), err_msg=f"nb={nb}")
    assert uniform_splitters(8, device="cpu").dtype == torch.int32


@pytest.mark.parametrize("lo,hi,differs_at", [
    (-1000, 1000, 24), (-(1 << 31), (1 << 31) - 1, 5),
    (5, (1 << 20) + 3, 21)])
def test_uniform_splitters_other_ranges_known_gap(lo, hi, differs_at):
    """Off (0, INT32_MAX) the port equals the JAX package's eager
    ``uniform_splitters(nb, lo, hi)`` exactly, on every bucket count
    2..1024: the port models the fused multiply-adds XLA's CPU backend
    contracts when it compiles ``jnp.linspace`` with the bounds as
    arguments (the gap this test once pinned). ``differs_at`` is a bucket
    count where the reference's other lowering, ``jnp.linspace`` jitted
    with constant bounds, gives other splitters; the port follows the
    eager function there too.

    The reference's splitters are the eager ``jnp.linspace`` program of
    ``uniform_splitters``, sliced and cast to int32 in numpy (exact for
    these ranges, and checked against ``uniform_splitters`` itself at a
    few counts): its slice and cast compile one more program each per
    count."""
    import jax
    import jax.numpy as jnp
    from repro.core.sort import uniform_splitters as juniform
    for nb in range(2, 1025):
        want = np.asarray(jnp.linspace(lo, hi, nb + 1))[1:-1].astype(np.int32)
        np.testing.assert_array_equal(
            uniform_splitters(nb, lo, hi, device="cpu").numpy(), want,
            err_msg=f"nb={nb}")
    for nb in (3, differs_at, 351, 352, 360, 1000, 1024):
        np.testing.assert_array_equal(
            uniform_splitters(nb, lo, hi, device="cpu").numpy(),
            np.asarray(juniform(nb, lo, hi)), err_msg=f"nb={nb}")
    jitted = jax.jit(lambda: jnp.linspace(lo, hi, differs_at + 1)[1:-1]
                     .astype(jnp.int32))()
    assert not np.array_equal(np.asarray(jitted),
                              np.asarray(juniform(differs_at, lo, hi)))


def test_sampled_splitters_match_jax(jax_ref):
    from repro_torch.core.sort import sampled_splitters
    keys, _, _ = terasort_inputs()
    rk = _ranks()
    got = sampled_splitters(interop.to_ranks(keys, rk), 16, 64, rk)
    np.testing.assert_array_equal(got.numpy(), jax_ref["sampled"])
    # JAX splitters carried across drive the port's terasort
    spl = interop.splitters_to_torch(jax_ref["sampled"], device="cpu")
    res = terasort(interop.to_ranks(keys, rk),
                   interop.to_ranks(np.arange(N, dtype=np.int32), rk), rk,
                   splitters=spl, buckets_per_device=2, capacity_factor=3.0)
    assert is_globally_sorted(res, 8) and int(res.dropped) == 0


def test_map_shuffle_reduce_pipeline_matches_jax(jax_ref):
    """The same UDF source text runs in both packages: map, a bucket
    shuffle under capacity pressure, and a reduce."""
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.obs.trace import Tracer
    keys, payload, _ = terasort_inputs()
    rk = _ranks()
    msr = eval(MSR_SRC, {"Dataflow": Dataflow})
    records = interop.records_to_ranks({"k": keys[:N_BYTES] % 1000,
                                        "v": payload[:N_BYTES]}, rk)
    runs_before = REGISTRY.counter("spmd.runs").value
    tracer = Tracer()
    res = msr.run(SPMDExecutor(rk), records, trace=tracer)
    valid = interop.to_global(res.valid)
    np.testing.assert_array_equal(valid, jax_ref["msr_valid"])
    for f in ("k", "v"):
        np.testing.assert_array_equal(interop.to_global(res.records[f])[valid],
                                      jax_ref[f"msr_{f}"][valid])
    assert int(res.dropped) == int(jax_ref["msr_dropped"]) > 0
    names = {s.name for s in tracer.buffer.spans()}
    assert {"spmd.run", "spmd.execute"} <= names
    assert REGISTRY.counter("spmd.runs").value == runs_before + 1
    assert res.trace is tracer
