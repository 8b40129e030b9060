"""The port's wide-area ``(dc, node)`` path against the JAX package.

The JAX references run on ``repro.compat.make_mesh((2, 4), ("dc",
"node"))`` in the one subprocess of ``tests/test_torch_jax_refs.py``; the
port runs the same numpy inputs on ``Ranks(shape=(2, 4), axes=("dc",
"node"), device="cpu")``. Every comparison is tile by tile — the same
record in the same slot of the same rank — and exact: integers, masks,
drop counts and (integer) combine sums. The unstable bitonic sort is held
to equal sorted keys and an equal (key, value) multiset per rank.
"""

import itertools
import types

import numpy as np
import pytest
import torch

from repro.core.shuffle import ShufflePlan as JShufflePlan
from repro.sector.topology import Topology as JTopology
from repro_torch import interop
from repro_torch.comm import Ranks
from repro_torch.core.introspect import collective_counts
from repro_torch.core.shuffle import (ShufflePlan, hierarchical_combine,
                                      hierarchical_shuffle, sphere_combine,
                                      sphere_shuffle)
from repro_torch.core.sort import SortResult, is_globally_sorted, terasort
from repro_torch.sector.topology import Topology
from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

from test_torch_jax_refs import (CAP, CAP_A, CAP_B, HIER_CASES, N_BYTES,
                                 N_RADIX, jax_references, shuffle_inputs,
                                 terasort_inputs)
from test_torch_terasort import _check_against


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return jax_references(tmp_path_factory)


def _grid():
    return Ranks(shape=(2, 4), axes=("dc", "node"), device="cpu")


# -- the grid communicator ------------------------------------------------------


def test_grid_all_to_all_psum_and_axis_index_follow_the_mesh():
    rk = _grid()
    assert rk.world == 8 and rk.axis_size("dc") == 2
    assert rk.axis_size(("dc", "node")) == 8
    np.testing.assert_array_equal(rk.axis_index("dc").numpy(),
                                  [0, 0, 0, 0, 1, 1, 1, 1])
    np.testing.assert_array_equal(rk.axis_index("node").numpy(),
                                  [0, 1, 2, 3] * 2)
    np.testing.assert_array_equal(rk.axis_index(("dc", "node")).numpy(),
                                  np.arange(8))
    # tile value = 100 * sender + 10 * tile index
    x = (torch.arange(8)[:, None] * 100 + torch.arange(4)[None, :] * 10)
    got = rk.all_to_all(x, "node")
    for (g, i), j in itertools.product(itertools.product(range(2), range(4)),
                                       range(4)):
        # tile j of rank (g, i) lands in row i of rank (g, j)
        assert int(got[g * 4 + j, i]) == (g * 4 + i) * 100 + j * 10
    x = (torch.arange(8)[:, None] * 100 + torch.arange(2)[None, :] * 10)
    got = rk.all_to_all(x, "dc")
    for g, i, h in itertools.product(range(2), range(4), range(2)):
        # tile h of rank (g, i) lands in row g of rank (h, i)
        assert int(got[h * 4 + i, g]) == (g * 4 + i) * 100 + h * 10
    v = torch.arange(8, dtype=torch.int32)
    assert int(rk.psum(v)) == 28
    np.testing.assert_array_equal(rk.psum(v, "node").numpy(),
                                  [6] * 4 + [22] * 4)
    np.testing.assert_array_equal(rk.psum(v, "dc").numpy(),
                                  [4, 6, 8, 10] * 2)
    assert rk.collectives["all_to_all"] == 2 and rk.collectives["psum"] == 3
    with pytest.raises(ValueError):
        rk.all_to_all(torch.zeros((8, 3)), "node")
    with pytest.raises(ValueError):
        Ranks(shape=(2, 4), device="cpu")          # a grid needs axis names


# -- the hierarchical shuffle ---------------------------------------------------


@pytest.mark.parametrize("wire_meta,chunks", HIER_CASES)
def test_hierarchical_shuffle_matches_jax_tile_by_tile(jax_ref, wire_meta,
                                                       chunks):
    data, buckets, valid = shuffle_inputs()
    rk = _grid()
    res = hierarchical_shuffle(interop.to_ranks(data, rk),
                               interop.to_ranks(buckets, rk), 16, CAP_A,
                               CAP_B, rk, valid=interop.to_ranks(valid, rk),
                               chunks=chunks, wire_meta=wire_meta)
    assert rk.collectives["all_to_all"] == 2 * chunks
    tag = f"hier_{wire_meta}{chunks}"

    def glob(t):
        return t.reshape((-1,) + tuple(t.shape[2:])).numpy()

    v = glob(res.valid)
    np.testing.assert_array_equal(v, jax_ref[f"{tag}_valid"])
    np.testing.assert_array_equal(glob(res.data)[v],
                                  jax_ref[f"{tag}_data"][v])
    np.testing.assert_array_equal(glob(res.a_valid),
                                  jax_ref[f"{tag}_a_valid"])
    assert int(res.dropped) == int(jax_ref[f"{tag}_dropped"]) > 0
    if wire_meta == "full":
        for f in ("bucket", "src_pos", "b_pos", "a_src"):
            np.testing.assert_array_equal(glob(getattr(res, f)),
                                          jax_ref[f"{tag}_{f}"], err_msg=f)
        # every delivered bucket sits on its owner
        owner = glob(res.bucket)[v] // 2
        rank = np.repeat(np.arange(8), 2 * res.valid.shape[2])
        np.testing.assert_array_equal(owner, rank[v.reshape(-1)])
    else:
        assert res.bucket is None and res.src_pos is None
        assert res.b_pos is None and res.a_src is None
    # conservation: delivered + dropped = sent
    sent = int((valid & (buckets >= 0) & (buckets < 16)).sum())
    assert int(v.sum()) + int(res.dropped) == sent


def test_hierarchical_combine_round_trip_matches_jax(jax_ref):
    data, buckets, valid = shuffle_inputs()
    rk = _grid()
    res = hierarchical_shuffle(interop.to_ranks(data, rk),
                               interop.to_ranks(buckets, rk), 16, CAP_A,
                               CAP_B, rk, valid=interop.to_ranks(valid, rk))
    before = rk.collectives["all_to_all"]
    out, hits = hierarchical_combine(res.data * 3, res, data.shape[0] // 8, rk)
    assert rk.collectives["all_to_all"] - before == 2
    np.testing.assert_array_equal(interop.to_global(out),
                                  jax_ref["hcombine_out"])
    np.testing.assert_array_equal(interop.to_global(hits),
                                  jax_ref["hcombine_hits"])
    h = interop.to_global(hits)
    assert set(np.unique(h)) <= {0, 1}
    # a delivered record comes back as itself times 3, undelivered as 0
    np.testing.assert_array_equal(interop.to_global(out),
                                  data * 3 * h[:, None])


def test_flat_sphere_combine_round_trip_matches_jax(jax_ref):
    data, buckets, valid = shuffle_inputs()
    rk = Ranks(8, device="cpu")
    res = sphere_shuffle(interop.to_ranks(data, rk),
                         interop.to_ranks(buckets, rk), 16, CAP, rk,
                         valid=interop.to_ranks(valid, rk))
    out, hits = sphere_combine(res.data * 3, res, data.shape[0] // 8, rk)
    np.testing.assert_array_equal(interop.to_global(out),
                                  jax_ref["fcombine_out"])
    np.testing.assert_array_equal(interop.to_global(hits),
                                  jax_ref["fcombine_hits"])


def test_combine_sums_float_results_to_float32_tolerance():
    """Float results take ``index_add_``; each origin row receives one
    result here, so the sum is exact on the CPU (on the card the order of
    float adds is not fixed; the stated tolerance is 1e-6 relative)."""
    data, buckets, valid = shuffle_inputs()
    rk = _grid()
    res = hierarchical_shuffle(interop.to_ranks(data, rk),
                               interop.to_ranks(buckets, rk), 16, CAP_A,
                               CAP_B, rk, valid=interop.to_ranks(valid, rk))
    out, hits = hierarchical_combine(res.data.to(torch.float32) * 0.5, res,
                                     data.shape[0] // 8, rk)
    want = data.astype(np.float32) * 0.5 * interop.to_global(hits)[:, None]
    np.testing.assert_allclose(interop.to_global(out), want, rtol=1e-6)


def test_collective_counts_match_jax(jax_ref):
    """1 all_to_all per flat hop, 2 per hierarchical hop (times chunks),
    +1 / +2 for the combines — the JAX jaxpr counts, read here from the
    ranks' counters."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 100, size=(8, 512, 3)).astype(np.int32)
    ids = rng.integers(0, 16, size=(8, 512)).astype(np.int32)
    for kind, rk in (("flat", Ranks(8, device="cpu")), ("hier", _grid())):
        plan = ShufflePlan.for_ranks(rk, 16, 512, 2.5)
        assert plan.hierarchical == (kind == "hier")
        d, b = torch.from_numpy(data), torch.from_numpy(ids)
        for w in (1, 2, 4):
            pw = ShufflePlan(plan.num_buckets, plan.axes, plan.shape,
                             plan.capacities, chunks=w)
            c = collective_counts(pw.shuffle, rk, d, b, ranks=rk)
            want = jax_ref[f"count_{kind}{w}"]
            assert (c["all_to_all"], c["all_gather"]) == tuple(want)

        def round_trip(plan=plan, rk=rk):
            r = plan.shuffle(rk, d, b)
            return plan.combine(rk, r.data * 2, r, 512)

        c = collective_counts(round_trip, ranks=rk)
        assert ((c["all_to_all"], c["all_gather"])
                == tuple(jax_ref[f"count_{kind}_combine"]))


# -- plans and the WAN cost model -----------------------------------------------


def _plan_pairs():
    """The plans of ``tests/test_wireframe.py:132-158`` in both packages."""
    for kw in (dict(num_buckets=8, axes=("w",), shape=(8,),
                    capacities=(100,)),
               dict(num_buckets=8, axes=("w",), shape=(8,),
                    capacities=(100,), chunks=4),
               dict(num_buckets=8, axes=("d", "n"), shape=(2, 4),
                    capacities=(50, 100)),
               dict(num_buckets=16, axes=("dc", "node"), shape=(2, 4),
                    capacities=(24, 40), chunks=3)):
        yield ShufflePlan(**kw), JShufflePlan(**kw)


def test_wan_profile_equals_jax():
    for tp, jp in _plan_pairs():
        assert tp.recv_slots == jp.recv_slots
        assert tp.stage_slots(0) == jp.stage_slots(0)
        for wire_meta in ("full", "bucket", "min"):
            for rec, seg in ((8, None), (100, 64), (100, None)):
                assert (tp.wan_profile(2, 4, rec, seg, wire_meta)
                        == jp.wan_profile(2, 4, rec, seg, wire_meta))
        with pytest.raises(ValueError):
            tp.wan_profile(2, 4, 8, wire_meta="bogus")
        with pytest.raises(ValueError):
            tp.wan_profile(3, 4, 8)


def test_from_topology_and_for_ranks_match_jax():
    cases = [(dict(pods=4, racks=1, nodes_per_rack=30), 120, 1200),
             (dict(pods=1, racks=2, nodes_per_rack=4), 16, 64),
             (dict(pods=2, racks=2, nodes_per_rack=2), 16, 100)]
    for topo, nb, n_local in cases:
        tp = ShufflePlan.from_topology(Topology(**topo), nb, n_local,
                                       chunks=2)
        jp = JShufflePlan.from_topology(JTopology(**topo), nb, n_local,
                                        chunks=2)
        assert ((tp.num_buckets, tp.axes, tp.shape, tp.capacities,
                 tp.chunks, tp.hierarchical, tp.num_devices,
                 tp.buckets_per_device, tp.recv_slots)
                == (jp.num_buckets, jp.axes, jp.shape, jp.capacities,
                    jp.chunks, jp.hierarchical, jp.num_devices,
                    jp.buckets_per_device, jp.recv_slots))
    mesh2 = types.SimpleNamespace(shape={"dc": 2, "node": 4})
    for n_local, cf in ((512, 2.0), (2048, 1.5), (100, 4.0)):
        jp = JShufflePlan.for_mesh(mesh2, 16, n_local, cf, ("dc", "node"))
        tp = ShufflePlan.for_ranks(_grid(), 16, n_local, cf)
        assert (tp.axes, tp.shape, tp.capacities) == (jp.axes, jp.shape,
                                                      jp.capacities)
    with pytest.raises(ValueError):
        ShufflePlan(num_buckets=8, axes=("a", "b"), shape=(2, 4),
                    capacities=(1,))
    with pytest.raises(ValueError):       # a plan checks the ranks it runs on
        ShufflePlan.for_ranks(_grid(), 16, 64).shuffle(
            Ranks(8, device="cpu"), torch.zeros((8, 4, 3)),
            torch.zeros((8, 4), dtype=torch.int32))


# -- terasort and the Dataflow sort on the grid ---------------------------------


def test_grid_terasort_bitonic_matches_jax(jax_ref):
    keys, payload, _ = terasort_inputs()
    rk = _grid()
    res = terasort(interop.to_ranks(keys, rk), interop.to_ranks(payload, rk),
                   rk, axis=("dc", "node"))
    assert rk.collectives["all_to_all"] == 2
    _check_against(res, jax_ref, "hier_bitonic", keys, stable=False)
    # the same sorted keys as the flat path
    flat = Ranks(8, device="cpu")
    fres = terasort(interop.to_ranks(keys, flat),
                    interop.to_ranks(payload, flat), flat)
    np.testing.assert_array_equal(res.keys[res.valid].numpy(),
                                  fres.keys[fres.valid].numpy())


def test_grid_terasort_radix_matches_jax_exactly(jax_ref):
    keys, payload, _ = terasort_inputs()
    keys, payload = keys[:N_RADIX], payload[:N_RADIX]
    rk = _grid()
    plan = ShufflePlan.for_ranks(rk, 8, N_RADIX // 8, 2.0)
    res = terasort(interop.to_ranks(keys, rk), interop.to_ranks(payload, rk),
                   rk, plan=plan, sort_algo="radix")
    _check_against(res, jax_ref, "hier_radix", keys, stable=True)


def test_grid_dataflow_sort_100_byte_records_matches_jax(jax_ref):
    keys, _, value = terasort_inputs()
    rk = _grid()
    records = interop.records_to_ranks({"key": keys[:N_BYTES],
                                        "value": value}, rk)
    df = Dataflow.source().sort(key=lambda r: r["key"], num_buckets=8)
    res = SPMDExecutor(rk, sort_algo="bitonic").run(df, records)
    valid = interop.to_global(res.valid)
    out_k = interop.to_global(res.records["key"])
    out_v = interop.to_global(res.records["value"])
    np.testing.assert_array_equal(valid, jax_ref["hbytes_valid"])
    np.testing.assert_array_equal(out_k[valid],
                                  jax_ref["hbytes_key"][valid])
    assert int(res.dropped) == int(jax_ref["hbytes_dropped"]) == 0
    per = valid.shape[0] // 8
    for r in range(8):
        sl = slice(r * per, (r + 1) * per)
        got = sorted(zip(out_k[sl][valid[sl]].tolist(),
                         map(bytes, out_v[sl][valid[sl]])))
        want = sorted(zip(jax_ref["hbytes_key"][sl][valid[sl]].tolist(),
                          map(bytes, jax_ref["hbytes_value"][sl][valid[sl]])))
        assert got == want
    # each value row still beside its key
    lookup = {int(k): bytes(v) for k, v in zip(keys[:N_BYTES], value)}
    assert all(lookup[int(k)] == bytes(v)
               for k, v in zip(out_k[valid], out_v[valid]))
    assert is_globally_sorted(SortResult(res.records["key"], None, res.valid,
                                         res.dropped), 8)


def test_grid_executor_rejects_axes_that_miss_ranks():
    rk = _grid()
    with pytest.raises(ValueError):
        SPMDExecutor(rk, axes=("node",))
    with pytest.raises(ValueError):
        SPMDExecutor(rk, plan=ShufflePlan.for_ranks(Ranks(8, device="cpu"),
                                                    8, 64))
