"""The port's kernels on the CPU (their plain versions) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs.

Every comparison is exact (tolerance 0): ranks, counts and sort outputs
are integers or permutations of the input. The bitonic kernel is not
stable, so it is held to equal sorted keys and an equal (key, value)
multiset per row; the radix sort is stable and held to exact equality.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import radix_sort as jradix
from repro.kernels.bitonic_sort import sort_kv_segments_pallas
from repro.kernels.partition import partition_rank_pallas
from repro_torch.kernels import autotune, ops, ref
from repro_torch.kernels import radix_sort as tradix
from repro_torch.kernels.bitonic_sort import sort_kv_segments_bitonic
from repro_torch.kernels.partition import partition_rank

@pytest.fixture(autouse=True)
def _fresh_autotuner():
    autotune.reset()
    saved = os.environ.pop(autotune.FORCE_ENV, None)
    yield
    autotune.reset()
    if saved is not None:
        os.environ[autotune.FORCE_ENV] = saved


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, uint32 carried through its int32 bits."""
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.contiguous().view(torch.int32).numpy().view(np.uint32)
    return t.contiguous().numpy()


def _keys(rng, shape, name, with_max=True):
    """Random keys with duplicate runs and +-0.0; ``with_max`` adds keys
    equal to the dtype maximum (+inf), which only a stable sort may see:
    the bitonic network pads with that value and may swap them."""
    if name == "float32":
        k = rng.standard_normal(shape).astype(np.float32)
        k.flat[::11] = 0.0
        k.flat[5::13] = -0.0
        if with_max:
            k.flat[3::17] = np.inf
        return k
    if name == "uint32":
        k = rng.integers(0, (1 << 32) - 1, size=shape, dtype=np.uint64)
        k = k.astype(np.uint32)
        if with_max:
            k.flat[::7] = np.iinfo(np.uint32).max
        return k
    k = rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int64)
    k = k.astype(np.int32)
    if with_max:
        k.flat[::7] = np.iinfo(np.int32).max
    k.flat[1::9] = 17                                    # duplicate runs
    return k


# -- K1: partition rank --------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 1000, 2500])
@pytest.mark.parametrize("num_dest", [1, 8, 9, 130])
def test_partition_rank_matches_pallas(n, num_dest):
    rng = np.random.default_rng(n * 1000 + num_dest)
    dest = rng.integers(-2, num_dest + 2, size=n).astype(np.int32)
    jr, jc = partition_rank_pallas(jnp.asarray(dest), num_dest, tile=1024,
                                   interpret=True)
    tr, tc = partition_rank(_t(dest), num_dest)
    in_range = (dest >= 0) & (dest < num_dest)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr.numpy()[in_range],
                                  np.asarray(jr)[in_range])


def test_partition_rank_batched_rows_match_per_row_pallas():
    """The stacked (rows, n) form ranks every row on its own."""
    rng = np.random.default_rng(3)
    dest = rng.integers(-1, 6, size=(3, 1500)).astype(np.int32)
    tr, tc = partition_rank(_t(dest), 5)
    for r in range(3):
        jr, jc = partition_rank_pallas(jnp.asarray(dest[r]), 5, tile=1024,
                                       interpret=True)
        ok = (dest[r] >= 0) & (dest[r] < 5)
        np.testing.assert_array_equal(tc[r].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tr[r].numpy()[ok], np.asarray(jr)[ok])


def test_partition_rank_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        partition_rank(torch.zeros(4, dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        partition_rank(torch.zeros(4, dtype=torch.int32), 4097)
    with pytest.raises(ValueError):
        partition_rank(torch.zeros((1, 2, 3), dtype=torch.int32), 2)


# -- K3: bitonic sort ----------------------------------------------------------


@pytest.mark.parametrize("rows,cols", [(1, 2), (3, 9), (4, 257), (17, 33)])
@pytest.mark.parametrize("name", ["int32", "uint32", "float32"])
def test_bitonic_matches_pallas_keys_and_multiset(rows, cols, name):
    rng = np.random.default_rng(rows * 100 + cols)
    keys = _keys(rng, (rows, cols), name, with_max=False)
    vals = np.arange(rows * cols, dtype=np.int32).reshape(rows, cols)
    jk, jv = sort_kv_segments_pallas(jnp.asarray(keys), jnp.asarray(vals),
                                     interpret=True)
    tk, tv = sort_kv_segments_bitonic(_t(keys), _t(vals))
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))
    for r in range(rows):
        assert (sorted(zip(_np(tk)[r].tolist(), _np(tv)[r].tolist()))
                == sorted(zip(np.asarray(jk)[r].tolist(),
                              np.asarray(jv)[r].tolist())))


# -- K2: radix sort ------------------------------------------------------------


@pytest.mark.parametrize("rows,cols", [(1, 1), (3, 257), (1, 520)])
@pytest.mark.parametrize("name", ["int32", "uint32", "float32"])
def test_radix_matches_pallas_exactly(rows, cols, name):
    rng = np.random.default_rng(rows * 1000 + cols)
    keys = _keys(rng, (rows, cols), name)
    vals = rng.integers(-2**31, 2**31 - 1, size=(rows, cols),
                        dtype=np.int64).astype(np.int32)
    jk, jv = jradix.sort_kv_segments_radix(jnp.asarray(keys),
                                           jnp.asarray(vals), interpret=True)
    tk, tv = tradix.sort_kv_segments_radix(_t(keys), _t(vals))
    np.testing.assert_array_equal(_np(tk).view(np.int32),
                                  np.asarray(jk).view(np.int32))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))


def test_radix_keys_only_and_float_payload():
    rng = np.random.default_rng(5)
    keys = _keys(rng, (2, 300), "float32")
    vals = rng.standard_normal((2, 300)).astype(np.float32)
    jk = jradix.sort_segments_radix(jnp.asarray(keys), interpret=True)
    np.testing.assert_array_equal(
        _np(tradix.sort_segments_radix(_t(keys))).view(np.int32),
        np.asarray(jk).view(np.int32))
    _, jv = jradix.sort_kv_segments_radix(jnp.asarray(keys), jnp.asarray(vals),
                                          interpret=True)
    _, tv = tradix.sort_kv_segments_radix(_t(keys), _t(vals))
    np.testing.assert_array_equal(_np(tv).view(np.int32),
                                  np.asarray(jv).view(np.int32))


@pytest.mark.parametrize("name", ["int32", "uint32", "float32"])
def test_sortable_bits_bijection_exact_both_ways(name):
    rng = np.random.default_rng(11)
    keys = _keys(rng, (4096,), name)
    jb = np.asarray(jradix.key_to_sortable_bits(jnp.asarray(keys)))
    tb = tradix.key_to_sortable_bits(_t(keys))
    np.testing.assert_array_equal(_np(tb), jb)
    back = tradix.sortable_bits_to_key(tb, _t(keys).dtype)
    np.testing.assert_array_equal(_np(back).view(np.int32),
                                  keys.view(np.int32))
    # unsigned order of the bits is the key order (-0.0 before +0.0)
    ordered = keys[np.argsort(_np(tb), kind="stable")]
    assert np.all(ordered[1:] >= ordered[:-1])


def test_radix_envelope_reasons():
    assert tradix.radix_supported(1 << 23) is None
    assert "int32 position" in tradix.radix_supported(1 << 31)
    assert "65535" in tradix.radix_supported(16, num_segments=70000)


def test_sort_wrappers_reject_bad_dtypes():
    with pytest.raises(TypeError):
        tradix.sort_kv_segments_radix(torch.zeros((1, 4), dtype=torch.int64),
                                      torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(TypeError):
        sort_kv_segments_bitonic(torch.zeros((1, 4), dtype=torch.int32),
                                 torch.zeros((1, 4), dtype=torch.int16))


# -- dispatch and the autotuner --------------------------------------------------


@pytest.mark.parametrize("algo", ["bitonic", "radix", "oracle"])
def test_ops_sort_dispatch_matches_stable_oracle(algo):
    rng = np.random.default_rng(9)
    keys = _t(_keys(rng, (3, 200), "int32", with_max=algo != "bitonic"))
    vals = torch.arange(600, dtype=torch.int32).reshape(3, 200)
    gk, gv = ops.sort_kv_segments(keys, vals, algo=algo)
    rk, rv = ref.sort_kv_segments_ref(keys, vals)
    assert torch.equal(gk, rk)
    assert torch.equal(ops.sort_segments(keys, algo=algo), rk)
    if autotune.is_stable(algo):
        assert torch.equal(gv, rv)


def test_autotune_cpu_records_why_kernels_are_not_candidates():
    c = autotune.choose(4, 8192, torch.int32, device="cpu")
    assert c.algo == "oracle" and c.source == "measured"
    assert set(c.skipped) == {"bitonic", "radix"}
    assert all("cpu backend" in r for r in c.skipped.values())
    again = autotune.choose(4, 8192, torch.int32, device="cpu")
    assert again.source == "cached" and again.algo == "oracle"
    assert autotune.MEASUREMENTS[autotune.cell_key(4, 8192, torch.int32,
                                                   True, "cpu")] == 1
    small = autotune.choose(2, 16, torch.int32, device="cpu")
    assert small.source == "static" and "bitonic" in small.skipped
    assert set(autotune.export_table()) == {
        autotune.cell_key(4, 8192, torch.int32, True, "cpu"),
        autotune.cell_key(2, 16, torch.int32, True, "cpu")}


def test_autotune_force_env_and_table():
    os.environ[autotune.FORCE_ENV] = "radix"
    try:
        assert autotune.choose(1, 16, torch.int32, device="cpu").algo == "radix"
        assert ops.resolve_sort_algo(1, 16, torch.int32, "bitonic",
                                     device="cpu") == "radix"
    finally:
        del os.environ[autotune.FORCE_ENV]
    key = autotune.cell_key(8, 4096, torch.float32, True, "cuda")
    autotune.load_table({key: {"algo": "bitonic"}})
    c = autotune.choose(8, 4096, torch.float32, device="cuda")
    assert (c.algo, c.source) == ("bitonic", "table")
    with pytest.raises(ValueError):
        ops.resolve_sort_algo(1, 4, torch.int32, "quick", device="cpu")


def test_bucket_histogram_ref_matches_jax():
    from repro.kernels import ref as jref
    rng = np.random.default_rng(12)
    ids = rng.integers(-3, 20, size=5000).astype(np.int32)
    np.testing.assert_array_equal(
        ref.bucket_histogram_ref(torch.from_numpy(ids), 17).numpy(),
        np.asarray(jref.bucket_histogram_ref(jnp.asarray(ids), 17)))
    rows = ref.bucket_histogram_ref(torch.from_numpy(ids.reshape(5, 1000)), 17)
    assert torch.equal(rows.sum(0), ref.bucket_histogram_ref(
        torch.from_numpy(ids), 17))


def test_pad_sentinel_matches_jax():
    from repro.kernels import ops as jops
    for tdt, jdt in [(torch.int32, jnp.int32), (torch.float32, jnp.float32),
                     (torch.uint32, jnp.uint32)]:
        assert ops.pad_sentinel(tdt) == jops.pad_sentinel(jdt)
