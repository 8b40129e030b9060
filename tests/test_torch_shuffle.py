"""The port's partition/pack and flat shuffle against the JAX package.

``partition_pack`` is compared in-process (one rank). The flat
``sphere_shuffle`` runs in the JAX package on 8 virtual CPU devices in the
subprocess of ``tests/test_torch_jax_refs.py``, which writes its outputs
to an ``.npz``; the port runs the same inputs on ``Ranks(8,
device="cpu")``. All comparisons are exact.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.shuffle import ShufflePlan as JShufflePlan
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.comm import Ranks
from repro_torch.core.shuffle import ShufflePlan, record_hops, sphere_shuffle
from repro_torch.kernels import ops

from test_torch_jax_refs import CAP, jax_references, shuffle_inputs

#: the JAX package's plain partition_pack, compiled once per shape.
_jax_pack = functools.partial(
    jax.jit(jops.partition_pack, static_argnums=(2, 3),
            static_argnames=("use_pallas",)), use_pallas=False)


@pytest.mark.parametrize("n,num_dest,capacity", [
    (1, 3, 2), (50, 4, 20), (300, 8, 30), (300, 8, 64), (1000, 9, 40)])
def test_partition_pack_matches_jax(n, num_dest, capacity):
    rng = np.random.default_rng(n + capacity)
    dest = rng.integers(-1, num_dest + 1, size=n).astype(np.int32)  # + overflow
    cols = [rng.integers(0, 1000, size=(n, 3)).astype(np.int32),
            rng.integers(0, 256, size=(n, 5)).astype(np.uint8)]
    jt, jin, jorg, jdrop = _jax_pack(
        [jnp.asarray(c) for c in cols], jnp.asarray(dest), num_dest, capacity)
    tt, tin, torg, tdrop = ops.partition_pack(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(dest),
        num_dest, capacity)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(torg.numpy(), np.asarray(jorg))
    assert int(tdrop) == int(jdrop)


def test_partition_pack_stacked_rows_match_per_row_jax():
    rng = np.random.default_rng(7)
    dest = rng.integers(0, 5, size=(3, 200)).astype(np.int32)
    col = rng.integers(0, 100, size=(3, 200, 2)).astype(np.int32)
    tt, tin, torg, tdrop = ops.partition_pack(
        [torch.from_numpy(col)], torch.from_numpy(dest), 4, 30)
    assert tt[0].shape == (3, 4, 30, 2) and tdrop.shape == (3,)
    for r in range(3):
        (jt,), jin, jorg, jdrop = _jax_pack(
            [jnp.asarray(col[r])], jnp.asarray(dest[r]), 4, 30)
        np.testing.assert_array_equal(tt[0][r].numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tin[r].numpy(), np.asarray(jin))
        np.testing.assert_array_equal(torg[r].numpy(), np.asarray(jorg))
        assert int(tdrop[r]) == int(jdrop)


def test_partition_pack_zero_records():
    tiles, in_rng, origin, dropped = ops.partition_pack(
        [torch.zeros((0, 4), dtype=torch.uint8)],
        torch.zeros((0,), dtype=torch.int32), 3, 5)
    assert tiles[0].shape == (3, 5, 4) and not bool(in_rng.any())
    assert bool((origin == -1).all()) and int(dropped) == 0


def test_plan_geometry_matches_jax():
    mesh = types.SimpleNamespace(shape={"data": 8})
    ranks = Ranks(8, device="cpu")
    for n_local, cf, chunks in [(512, 2.0, 1), (2048, 1.5, 4), (100, 4.0, 3)]:
        jp = JShufflePlan.for_mesh(mesh, 16, n_local, cf, chunks=chunks)
        tp = ShufflePlan.for_ranks(ranks, 16, n_local, cf, chunks=chunks)
        assert (tp.axes, tp.shape) == (jp.axes, jp.shape)
        assert tp.capacities == jp.capacities
        assert tp.stage_slots(0) == jp.stage_slots(0)
        assert tp.recv_slots == jp.recv_slots
        assert tp.buckets_per_device == jp.buckets_per_device
    with pytest.raises(ValueError):
        ShufflePlan(num_buckets=12, axes=("data",), shape=(8,),
                    capacities=(4,))


@pytest.fixture(scope="module")
def jax_shuffle(tmp_path_factory):
    refs = jax_references(tmp_path_factory)
    return {k[len("shuffle_"):]: v for k, v in refs.items()
            if k.startswith("shuffle_")}


@pytest.mark.parametrize("chunks", [1, 4])
def test_sphere_shuffle_8_ranks_matches_jax(jax_shuffle, chunks):
    data, buckets, valid = shuffle_inputs()
    ranks = Ranks(8, device="cpu")
    hops = []
    with record_hops(hops):
        res = sphere_shuffle(interop.to_ranks(data, ranks),
                             interop.to_ranks(buckets, ranks), 16, CAP, ranks,
                             valid=interop.to_ranks(valid, ranks),
                             chunks=chunks)
    assert len(hops) == 1 and hops[0]["chunks"] == chunks
    assert ranks.collectives["all_to_all"] == chunks
    got_valid = interop.to_global(res.valid.reshape(8, -1))
    want_valid = jax_shuffle[f"valid{chunks}"]
    got_data = interop.to_global(res.data.reshape(8, -1, 3))
    want_data = jax_shuffle[f"data{chunks}"]
    assert int(res.dropped) == int(jax_shuffle[f"dropped{chunks}"]) > 0
    assert got_valid.sum() == want_valid.sum()
    # the same layout: every slot of every rank carries the same record
    np.testing.assert_array_equal(got_valid, want_valid)
    np.testing.assert_array_equal(got_data[got_valid], want_data[want_valid])
    np.testing.assert_array_equal(
        interop.to_global(res.bucket.reshape(8, -1)),
        jax_shuffle[f"bucket{chunks}"])
    np.testing.assert_array_equal(
        interop.to_global(res.src_pos.reshape(8, -1)),
        jax_shuffle[f"src{chunks}"])
    # per-rank delivered multiset, and every bucket on its owner
    per = got_valid.shape[0] // 8
    for r in range(8):
        sl = slice(r * per, (r + 1) * per)
        assert (sorted(map(tuple, got_data[sl][got_valid[sl]]))
                == sorted(map(tuple, want_data[sl][want_valid[sl]])))
        b = interop.to_global(res.bucket.reshape(8, -1))[sl][got_valid[sl]]
        assert ((b // 2) == r).all()
