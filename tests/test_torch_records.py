"""RecordCodec and WireFrame bytes: the port against the JAX package.

Both packages get the same numpy records; every byte must agree (a bucket
file written by one package is readable by the other).
"""

import jax.numpy as jnp
import gc
import weakref

import numpy as np
import pytest
import torch

from repro.core import records as jrec
from repro_torch.core import records as trec


def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "flag": rng.integers(0, 2, size=n).astype(bool),
        "pair": (rng.integers(-128, 127, size=(n, 3)).astype(np.int8),
                 rng.standard_normal((n, 2, 2)).astype(np.float32)),
        "key": rng.integers(-2**31, 2**31 - 1, size=n).astype(np.int32),
        "blob": rng.integers(0, 256, size=(n, 5)).astype(np.uint8),
    }


def _jax(tree):
    import jax
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return trec.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("n", [0, 1, 37])
def test_codec_pack_and_encode_byte_identical(n):
    recs = _records(n)
    jc = jrec.RecordCodec.from_example(_jax(recs))
    tc = trec.RecordCodec.from_example(_torch(recs))
    assert tc.dtypes == jc.dtypes and tc.shapes == jc.shapes
    assert tc.nbytes == jc.nbytes
    want = np.asarray(jc.pack(_jax(recs)))
    np.testing.assert_array_equal(tc.pack(_torch(recs)).numpy(), want)
    np.testing.assert_array_equal(tc.encode(recs), jc.encode(recs))
    np.testing.assert_array_equal(tc.encode(recs), want)
    # unpack / decode give back the records, bit for bit
    back = tc.unpack(torch.from_numpy(want.copy()))
    for a, b in zip(trec.tree_flatten(back)[0], trec.tree_flatten(recs)[0]):
        np.testing.assert_array_equal(a.numpy(), b)
    dec = tc.decode(want.tobytes())
    assert trec.tree_flatten(dec)[1] == trec.tree_flatten(recs)[1]


def test_codec_float64_and_int64_via_numpy():
    rng = np.random.default_rng(1)
    recs = (rng.standard_normal(9), rng.integers(-2**62, 2**62, size=(9, 2)))
    jc = jrec.RecordCodec.from_example(recs)
    tc = trec.RecordCodec.from_example(recs)
    want = jc.encode(recs)
    np.testing.assert_array_equal(tc.encode(recs), want)
    np.testing.assert_array_equal(tc.pack(_torch(recs)).numpy(), want)
    got = tc.decode(want)
    np.testing.assert_array_equal(got[0], recs[0])
    np.testing.assert_array_equal(got[1], recs[1])


def test_codec_from_fields_layout_matches_jax():
    fields = {"value": (np.uint8, (96,)), "key": np.int32, "flag": np.bool_}
    jc = jrec.RecordCodec.from_fields(fields)
    tc = trec.RecordCodec.from_fields(fields)
    assert (tc.layout, tc.dtypes, tc.shapes) == (jc.layout, jc.dtypes,
                                                 jc.shapes)
    rng = np.random.default_rng(2)
    recs = {"value": rng.integers(0, 256, size=(4, 96)).astype(np.uint8),
            "key": np.arange(4, dtype=np.int32),
            "flag": np.array([True, False, True, True])}
    want = np.asarray(jc.pack(_jax(recs)))
    np.testing.assert_array_equal(tc.pack(_torch(recs)).numpy(), want)
    np.testing.assert_array_equal(tc.encode(recs), want)


def test_codec_stacked_ranks_pack_per_rank_rows():
    """(ranks, n) leaves pack to (ranks, n, nbytes): each rank's rows equal
    the JAX pack of that rank's records."""
    recs = _records(4 * 6, seed=3)
    stacked = trec.tree_map(
        lambda a: torch.from_numpy(a.reshape((4, 6) + a.shape[1:])), recs)
    tc = trec.RecordCodec.from_example(stacked, batch_dims=2)
    got = tc.pack(stacked).numpy()
    jc = jrec.RecordCodec.from_example(_jax(recs))
    want = np.asarray(jc.pack(_jax(recs))).reshape(4, 6, -1)
    np.testing.assert_array_equal(got, want)


def test_codec_rejects_schema_mismatch():
    tc = trec.RecordCodec.from_example(_torch(_records(3)))
    with pytest.raises(ValueError):
        tc.pack({"key": torch.zeros(3, dtype=torch.int32)})
    bad = _torch(_records(3))
    bad["key"] = bad["key"].to(torch.int64)
    with pytest.raises(ValueError):
        tc.pack(bad)


@pytest.mark.parametrize("dtype,shape", [(np.int32, ()), (np.uint8, (7,)),
                                         (np.float32, (2, 3)),
                                         (np.bool_, (2,)), (np.uint8, (2,))])
@pytest.mark.parametrize("meta", [(), ("bucket",), ("bucket", "src")])
def test_wireframe_positional_bytes_match_jax(dtype, shape, meta):
    rng = np.random.default_rng(4)
    d, c = 3, 5
    payload = rng.integers(0, 100, size=(d * c,) + shape).astype(dtype)
    metas = {m: rng.integers(-5, 50, size=d * c).astype(np.int32)
             for m in meta}
    jf = jrec.WireFrame.for_payload(jnp.asarray(payload), meta=meta)
    tf = trec.WireFrame.for_payload(torch.from_numpy(payload), meta=meta)
    assert tf == trec.WireFrame(jf.payload_dtype, jf.payload_shape, jf.meta,
                                jf.explicit_valid)
    assert (tf.row_nbytes, tf.tile_nbytes(c)) == (jf.row_nbytes,
                                                  jf.tile_nbytes(c))
    jrows = np.asarray(jf.frame_rows(jnp.asarray(payload),
                                     **{k: jnp.asarray(v)
                                        for k, v in metas.items()}))
    trows = tf.frame_rows(torch.from_numpy(payload),
                          **{k: torch.from_numpy(v) for k, v in metas.items()})
    np.testing.assert_array_equal(trows.numpy(), jrows)
    counts = np.array([5, 0, 3], np.int32)
    jwire = np.asarray(jf.seal(jnp.asarray(jrows.reshape(d, c, -1)),
                               jnp.asarray(counts)))
    twire = tf.seal(trows.reshape(d, c, -1), torch.from_numpy(counts))
    np.testing.assert_array_equal(twire.numpy(), jwire)
    jp, jv, jm = jf.open(jnp.asarray(jwire))
    tp, tv, tm = tf.open(twire)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))


def test_wireframe_explicit_valid_bytes_match_jax():
    rng = np.random.default_rng(5)
    payload = rng.standard_normal((12, 3)).astype(np.float32)
    src = np.arange(12, dtype=np.int32)
    valid = rng.integers(0, 2, size=12).astype(bool)
    jf = jrec.WireFrame.for_payload(jnp.asarray(payload), meta=("src",),
                                    explicit_valid=True)
    tf = trec.WireFrame.for_payload(torch.from_numpy(payload), meta=("src",),
                                    explicit_valid=True)
    jrows = np.asarray(jf.frame_rows(jnp.asarray(payload),
                                     valid=jnp.asarray(valid),
                                     src=jnp.asarray(src)))
    trows = tf.frame_rows(torch.from_numpy(payload),
                          valid=torch.from_numpy(valid),
                          src=torch.from_numpy(src))
    np.testing.assert_array_equal(trows.numpy(), jrows)
    jp, jv, jm = jf.open_rows(jnp.asarray(jrows))
    tp, tv, tm = tf.open_rows(trows)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm["src"].numpy(), np.asarray(jm["src"]))
    with pytest.raises(ValueError):
        tf.seal(trows.reshape(3, 4, -1), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        tf.frame_rows(torch.from_numpy(payload), src=torch.from_numpy(src))


def test_tree_unflatten_frees_its_leaves_without_the_cycle_collector():
    """Rebuilding a tree must leave no reference cycle behind: one would
    keep whole record buffers alive until the cyclic collector ran (on the
    card, gigabytes of peak memory)."""
    tree = {"a": torch.zeros(4), "b": (torch.ones(2), [torch.ones(3)])}
    enabled = gc.isenabled()
    gc.disable()
    try:
        out = trec.tree_map(lambda x: x * 2, tree)
        refs = [weakref.ref(t) for t in trec.tree_flatten(out)[0]]
        del out
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()
