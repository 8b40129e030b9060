"""The port's chaos layer — fault plans, schedules, hop and stream
checkpoints, elastic re-ranking and the executors' fault paths — against
the JAX package, on the CPU.

- Host faults run in-process: each case builds one Sector deployment per
  package under ``tmp_path`` (``make_sector``), runs the same wordcount
  (``jax.numpy`` UDFs on the reference, torch UDFs on the port with
  ``device="cpu"``) under the same :class:`FaultPlan`, and requires the
  same events text (the same victims), the same records, and the same
  ``recoveries``, ``retries`` and ``data_errors``. The cases mirror
  ``tests/test_chaos.py``'s host cases.
- SPMD faults hold the port on ``Ranks(8, device="cpu")`` and the ``(dc,
  node) = (2, 4)`` grid against the JAX package on 8 virtual devices (the
  session-shared subprocess of ``tests/test_torch_jax_stream_refs.py``):
  the same lost rank, the same multiset and the same ``dropped``.
- Checkpoints: :class:`StreamCheckpoint` bytes equal the reference's for
  the same carry and tickets; a :class:`HopCheckpoint`'s rows are the
  reference's ``encode`` rows.
"""

import collections
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.mapreduce as j_mr
import repro.core.records as j_records
import repro.launch.train as j_train
import repro.sphere.chaos as j_chaos
import repro.sphere.dataflow as j_dataflow
import repro.sphere.spe as j_spe
import repro_torch.core.mapreduce as t_mr
import repro_torch.core.records as t_records
import repro_torch.launch.train as t_train
import repro_torch.sphere.chaos as t_chaos
import repro_torch.sphere.dataflow as t_dataflow
import repro_torch.sphere.spe as t_spe
from repro_torch.comm import Ranks
from repro_torch.train.elastic import remesh, shrink_mesh

from test_torch_jax_stream_refs import (NB, SEEDS, matrix_words,
                                        sort_inputs, stream_references,
                                        two_hop_words)

N_PAGES = 4


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return stream_references(tmp_path_factory)


def _jemit(rec):
    return {"key": rec["word"].astype(jnp.int32),
            "value": jnp.ones_like(rec["word"], jnp.int32)}


def _jcount(rec, valid):
    k, v, dropped = j_mr.reduce_by_key_sum(rec["key"], rec["value"], valid)
    return {"key": k, "value": v}, k >= 0, dropped


def _temit(rec):
    return {"key": torch.as_tensor(rec["word"]).to(torch.int32),
            "value": torch.ones_like(torch.as_tensor(rec["word"]),
                                     dtype=torch.int32)}


def _tcount(rec, valid):
    k, v, dropped = t_mr.reduce_by_key_sum(rec["key"], rec["value"], valid)
    return {"key": k, "value": v}, k >= 0, dropped


JAX = types.SimpleNamespace(
    make_sector=j_train.make_sector, Dataflow=j_dataflow.Dataflow,
    HostExecutor=j_dataflow.HostExecutor, SPE=j_spe.SPE,
    SegmentLost=j_spe.SegmentLost, RecordCodec=j_records.RecordCodec,
    chaos=j_chaos, emit=_jemit, count=_jcount, hash=j_mr.default_hash,
    first=lambda a: int(np.asarray(a).reshape(-1)[0]), kw={})
PORT = types.SimpleNamespace(
    make_sector=t_train.make_sector, Dataflow=t_dataflow.Dataflow,
    HostExecutor=t_dataflow.HostExecutor, SPE=t_spe.SPE,
    SegmentLost=t_spe.SegmentLost, RecordCodec=t_records.RecordCodec,
    chaos=t_chaos, emit=_temit, count=_tcount,
    hash=lambda k, nb: t_mr.default_hash(torch.as_tensor(k), nb),
    first=lambda a: int(torch.as_tensor(a).reshape(-1)[0]),
    kw={"device": "cpu"})
SIDES = (JAX, PORT)


def _pipeline(side, emit=None):
    codec = side.RecordCodec.from_fields({"word": np.uint8,
                                          "page": np.uint8})
    return (side.Dataflow.source(codec)
            .map(emit or side.emit)
            .shuffle(by=lambda r: side.hash(r["key"], NB), num_buckets=NB)
            .reduce(side.count))


def _pages(seed=7, n=160):
    return np.random.default_rng(seed).integers(0, 26, size=(n, 2),
                                                dtype=np.uint8)


def _deploy(side, root, pages, num_slaves=6):
    root.mkdir(parents=True, exist_ok=True)
    master, client, daemon = side.make_sector(str(root),
                                              num_slaves=num_slaves)
    client.upload_dataset("/web/page",
                          [p.tobytes() for p in np.split(pages, N_PAGES)])
    daemon.run_until_stable()
    spes = [side.SPE(i, master.slaves[i].address, master, client.session_id)
            for i in range(num_slaves)]
    paths = [f"/web/page.{i:05d}" for i in range(N_PAGES)]
    return master, client, daemon, spes, paths


def _counts(res):
    rec = res.valid_records()
    return {int(k): int(v) for k, v in zip(rec["key"], rec["value"])}


def _host_run(side, root, pages, chaos_fn, num_slaves=6, spes_fn=None,
              pipeline=None):
    master, client, daemon, spes, paths = _deploy(side, root, pages,
                                                  num_slaves)
    if spes_fn is not None:
        spes = spes_fn(side, master, client)
    chaos = chaos_fn(side)
    ex = side.HostExecutor(master, client, spes, daemon=daemon, **side.kw)
    res = ex.run(pipeline or _pipeline(side), paths, chaos=chaos)
    return types.SimpleNamespace(
        res=res, chaos=chaos, master=master, ex=ex, counts=_counts(res),
        events=list(chaos.events) if chaos is not None else [],
        acct=(res.recoveries, res.retries, res.data_errors,
              int(res.dropped)))


def _both(tmp_path, pages, chaos_fn, **kw):
    j = _host_run(JAX, tmp_path / "jax", pages, chaos_fn, **kw)
    t = _host_run(PORT, tmp_path / "port", pages, chaos_fn, **kw)
    assert t.events == j.events
    assert t.counts == j.counts
    assert t.acct == j.acct
    return j, t


# -- HostExecutor chaos matrix -------------------------------------------------


@pytest.mark.parametrize("seed", list(SEEDS))
@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("kind", ["kill_slave", "drop_bucket"])
def test_host_chaos_matches_jax(tmp_path, kind, phase, seed):
    """One Sector fault at each boundary: the same victim (events text),
    the fault-free multiset, nothing dropped, no errors, and the same
    recoveries and retries as the JAX package."""
    pages = _pages()
    want = dict(collections.Counter(pages[:, 0].tolist()))
    _, t = _both(tmp_path, pages, lambda side: side.chaos.FaultPlan(
        kind=kind, phase=phase, seed=seed))
    assert t.chaos.fired
    assert not t.res.errors and t.res.data_errors == 0
    assert int(t.res.dropped) == 0
    assert t.counts == want
    n_segments = N_PAGES + NB
    assert t.res.retries <= n_segments * (t.ex.max_retries + 6)
    if kind == "drop_bucket":
        assert t.res.recoveries >= 1 and t.master.stats["recoveries"] >= 1


def test_host_chaos_is_deterministic(tmp_path):
    pages = _pages()
    runs = [_host_run(PORT, tmp_path / sub, pages,
                      lambda side: side.chaos.FaultPlan(
                          kind="drop_bucket", phase=0, seed=3))
            for sub in ("a", "b")]
    assert (runs[0].events, runs[0].counts) == (runs[1].events,
                                                runs[1].counts)
    j = _host_run(JAX, tmp_path / "jax", pages,
                  lambda side: side.chaos.FaultPlan(kind="drop_bucket",
                                                    phase=0, seed=3))
    assert runs[0].events == j.events and runs[0].counts == j.counts


def test_host_kill_slave_repools_crashed_spe(tmp_path):
    pages = _pages()
    want = dict(collections.Counter(pages[:, 0].tolist()))

    def spes(side, master, client):
        from repro_torch.sector.topology import NodeAddress
        return [side.SPE(0, master.slaves[0].address, master,
                         client.session_id),
                side.SPE(1, NodeAddress(9, 9, 9), master, client.session_id)]

    _, t = _both(tmp_path, pages, lambda side: side.chaos.FaultPlan(
        kind="kill_slave", phase=0, victim=0, wipe=True), num_slaves=4,
        spes_fn=spes)
    assert t.chaos.fired and "crashed SPEs [0]" in t.events[0]
    assert t.res.retries >= 1
    assert not t.res.errors and t.counts == want


def test_host_lost_forever_is_counted_data_error(tmp_path):
    pages = _pages()
    got = {}
    for side in SIDES:
        root = tmp_path / ("port" if side is PORT else "jax")
        master, client, daemon, spes, paths = _deploy(side, root, pages)
        for slave in master.slaves.values():
            slave.drop_file(paths[0])
        res = side.HostExecutor(master, client, spes, daemon=daemon,
                                **side.kw).run(_pipeline(side), paths)
        got[side is PORT] = (_counts(res), res.data_errors, res.retries,
                             res.recoveries, master.stats["lost_files"],
                             sorted(v.split(":")[0]
                                    for v in res.errors.values()))
    assert got[True] == got[False]
    counts, data_errors, _, _, lost, kinds = got[True]
    assert data_errors >= 1 and lost >= 1 and "DATA_ERROR" in kinds
    want = collections.Counter(
        np.concatenate(np.split(pages, N_PAGES)[1:])[:, 0].tolist())
    assert counts == dict(want)


def test_host_udf_error_exhausts_retries_as_data_error(tmp_path):
    pages = _pages().copy()
    pages[:, 1] = np.repeat(np.arange(N_PAGES, dtype=np.uint8), 40)
    got = {}
    for side in SIDES:
        def poisoned(rec, side=side):
            if side.first(rec["page"]) == 0:
                raise ValueError("poisoned segment")
            return side.emit(rec)

        root = tmp_path / ("port" if side is PORT else "jax")
        master, client, daemon, spes, paths = _deploy(side, root, pages)
        res = side.HostExecutor(master, client, spes, daemon=daemon,
                                **side.kw).run(_pipeline(side, poisoned),
                                               paths)
        bad = [v for v in res.errors.values() if v.startswith("DATA_ERROR")]
        assert len(bad) == res.data_errors >= 1 and "poisoned" in bad[0]
        got[side is PORT] = (_counts(res), res.data_errors, res.retries)
    assert got[True] == got[False]
    want = collections.Counter(
        np.concatenate(np.split(pages, N_PAGES)[1:])[:, 0].tolist())
    assert got[True][0] == dict(want)


def test_segment_lost_exception_carries_path(tmp_path):
    from repro_torch.core.stream import SegmentInfo
    pages = _pages()
    master, client, _, spes, paths = _deploy(PORT, tmp_path, pages)
    for slave in master.slaves.values():
        slave.drop_file(paths[1])
    with pytest.raises(t_spe.SegmentLost) as ei:
        spes[0].read_segment(SegmentInfo(0, paths[1], 0, 4), record_bytes=2)
    assert ei.value.path == paths[1] and isinstance(ei.value, IOError)


# -- ChaosSchedule -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_chaos_schedule_multi_fault_host_matches_jax(tmp_path, seed):
    """kill_slave @ 0 then rejoin_slave @ 1: one shared audit log, the
    same on both packages, and the fault-free multiset."""
    pages = _pages()
    want = dict(collections.Counter(pages[:, 0].tolist()))
    _, t = _both(tmp_path, pages, lambda side: side.chaos.ChaosSchedule([
        side.chaos.FaultPlan(kind="kill_slave", phase=0),
        side.chaos.FaultPlan(kind="rejoin_slave", phase=1)], seed=seed))
    assert t.chaos.fired and t.chaos.fired_count == 2
    assert not t.res.errors and t.counts == want
    assert "killed slave" in t.events[0]
    assert "incarnation 1" in next(e for e in t.events if "rejoined" in e)
    assert all(s.alive for s in t.master.slaves.values())


def test_chaos_schedule_seeds_match_jax():
    for schedule_seed in (0, 1, 7):
        got = []
        for side in SIDES:
            s = side.chaos.ChaosSchedule(
                [side.chaos.FaultPlan(kind="lose_device", at_batch=0),
                 side.chaos.FaultPlan(kind="lose_device", at_batch=1),
                 side.chaos.FaultPlan(kind="kill_slave", phase=2, seed=5)],
                seed=schedule_seed)
            got.append(([f.seed for f in s.faults],
                        [f._rng().random() for f in s.faults],
                        [f._pick_device(8) for f in s.faults[:2]], repr(s)))
        assert got[0] == got[1]
    s = t_chaos.ChaosSchedule([t_chaos.FaultPlan(kind="lose_batch",
                                                 at_batch=4)])
    assert s.kinds == ("lose_batch",)
    assert s.due_at_batch(3) == [] and s.due_at_batch(4) == s.faults
    assert not s.fired and s.fired_count == 0
    a = [f.seed for f in t_chaos.ChaosSchedule(
        [t_chaos.FaultPlan(kind="lose_device", at_batch=0),
         t_chaos.FaultPlan(kind="lose_device", at_batch=1)], seed=0).faults]
    assert a[0] != a[1]


def test_fault_plan_rejects_unknown_kind():
    for side in SIDES:
        with pytest.raises(ValueError, match="unknown fault kind"):
            side.chaos.FaultPlan(kind="meteor_strike")
    assert t_chaos.KINDS == j_chaos.KINDS
    assert (t_chaos.HOST_KINDS, t_chaos.SPMD_KINDS, t_chaos.STREAM_KINDS) == (
        j_chaos.HOST_KINDS, j_chaos.SPMD_KINDS, j_chaos.STREAM_KINDS)


# -- checkpoints -----------------------------------------------------------------


@dataclasses.dataclass
class _Tk:
    req_id: int


def _carry(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return ({"key": rng.integers(0, 99, n).astype(np.int32),
             "value": rng.integers(0, 9, n).astype(np.int32)},
            rng.integers(0, 2, n).astype(bool))


def test_stream_checkpoint_bytes_equal_jax():
    """The same carry and tickets give the reference's bytes, whether the
    port's carry is numpy rows or tensors stacked over ranks; the bytes
    round-trip and re-stack onto fewer ranks."""
    carry = _carry()
    tickets = [_Tk(3), _Tk(11), _Tk(7)]
    want = j_chaos.StreamCheckpoint.seal(5, tickets, carry).to_bytes()
    assert t_chaos.StreamCheckpoint.seal(5, tickets, carry).to_bytes() == want
    stacked = ({k: torch.from_numpy(v).reshape(4, 4)
                for k, v in carry[0].items()},
               torch.from_numpy(carry[1]).reshape(4, 4))
    blob = t_chaos.StreamCheckpoint.seal(5, tickets, stacked).to_bytes()
    assert blob == want and blob.startswith(t_chaos.StreamCheckpoint.MAGIC)
    back = t_chaos.StreamCheckpoint.from_bytes(blob)
    assert back.step == 5 and back.ticket_ids == (3, 11, 7)
    assert back.to_bytes() == want
    rec, valid = back.restore_carry(Ranks(2, device="cpu"), ("data",))
    for k in carry[0]:
        np.testing.assert_array_equal(rec[k].reshape(-1).numpy(),
                                      carry[0][k])
        assert tuple(rec[k].shape) == (2, 8)
    np.testing.assert_array_equal(valid.reshape(-1).numpy(), carry[1])
    empty = t_chaos.StreamCheckpoint.seal(0, [], None)
    assert empty.to_bytes() == j_chaos.StreamCheckpoint.seal(
        0, [], None).to_bytes()
    back = t_chaos.StreamCheckpoint.from_bytes(empty.to_bytes())
    assert back.carry is None
    assert back.restore_carry(Ranks(1, device="cpu"), ("data",)) is None
    with pytest.raises(ValueError, match="not a StreamCheckpoint"):
        t_chaos.StreamCheckpoint.from_bytes(b"nope")
    with pytest.raises(TypeError, match="flat dict-of-array"):
        t_chaos.StreamCheckpoint.seal(
            1, [], ((np.zeros(4, np.int32),), np.ones(4, bool))).to_bytes()


def test_hop_checkpoint_roundtrip_bit_identical():
    """Mixed dtypes, trailing shapes and bools: the host rows are the
    reference's ``encode`` rows, and restoring onto 8, 4, 2 and 1 ranks
    gives every field back exactly."""
    rng = np.random.default_rng(0)
    records = {"k": rng.integers(0, 1 << 30, 16).astype(np.int32),
               "v": rng.random((16, 3)).astype(np.float32),
               "b": rng.integers(0, 2, 16).astype(bool)}
    valid = rng.integers(0, 2, 16).astype(bool)
    want = j_chaos.HopCheckpoint.snapshot(records, valid, hop=2, dropped=5)
    stacked = {k: torch.from_numpy(v).reshape((8, 2) + v.shape[1:])
               for k, v in records.items()}
    ckpt = t_chaos.HopCheckpoint.snapshot(
        stacked, torch.from_numpy(valid).reshape(8, 2), hop=2, dropped=5)
    assert ckpt.payload.dtype == np.uint8 and ckpt.hop == 2
    assert ckpt.dropped == 5
    np.testing.assert_array_equal(ckpt.payload, want.payload)
    np.testing.assert_array_equal(ckpt.valid, want.valid)
    for world in (8, 4, 2, 1):
        rec, v = ckpt.restore(Ranks(world, device="cpu"), ("data",))
        for k in records:
            assert rec[k].shape[:2] == (world, 16 // world)
            np.testing.assert_array_equal(
                rec[k].reshape((16,) + records[k].shape[1:]).numpy(),
                records[k])
        np.testing.assert_array_equal(v.reshape(-1).numpy(), valid)
    # the restored tensors own their memory
    rec, _ = ckpt.restore(Ranks(8, device="cpu"), ("data",))
    rec["k"].zero_()
    assert ckpt.payload.any()


# -- guard rails -------------------------------------------------------------------


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_chaos_guard_rails_match_jax(tmp_path):
    import jax
    mesh = jax.make_mesh((1,), ("data",))
    jex = j_dataflow.SPMDExecutor(mesh)
    tex = t_dataflow.SPMDExecutor(Ranks(1, device="cpu"))
    jdata = {"key": np.arange(8, dtype=np.int32)}
    tdata = {"key": np.arange(8, dtype=np.int32).reshape(1, 8)}
    cases = [
        (lambda s: s.Dataflow.source().map(lambda r: r),
         lambda s: s.chaos.FaultPlan(kind="kill_slave"), None),
        (lambda s: s.Dataflow.source().map(lambda r: r),
         lambda s: s.chaos.FaultPlan(kind="lose_batch", at_batch=1), None),
        (lambda s: s.Dataflow.source().shuffle(by=lambda r: r["key"] % 2),
         lambda s: s.chaos.FaultPlan(kind="none"), None),
        (lambda s: s.Dataflow.source().sort(key=lambda r: r["key"]),
         lambda s: s.chaos.FaultPlan(kind="none"), None),
        (lambda s: s.Dataflow.source().map(lambda r: r),
         lambda s: s.chaos.FaultPlan(kind="none"),
         ({"key": np.zeros(2, np.int32)}, np.ones(2, bool))),
    ]
    for df, plan, carry in cases:
        want = _error(lambda: jex.run(df(JAX), jdata, chaos=plan(JAX),
                                      carry=carry))
        tcarry = None if carry is None else (
            {"key": carry[0]["key"].reshape(1, 2)}, carry[1].reshape(1, 2))
        got = _error(lambda: tex.run(df(PORT), tdata, chaos=plan(PORT),
                                     carry=tcarry))
        assert got == want
    pages = _pages()
    for kind in ("lose_device", "lose_batch"):
        msgs = []
        for side in SIDES:
            root = tmp_path / f"{kind}{side is PORT}"
            master, client, daemon, spes, paths = _deploy(side, root, pages)
            msgs.append(_error(lambda: side.HostExecutor(
                master, client, spes, **side.kw).run(
                    _pipeline(side), paths,
                    chaos=side.chaos.FaultPlan(kind=kind))))
        assert msgs[0] == msgs[1]
        assert "fault; inject it via" in msgs[1]


# -- elastic re-ranking --------------------------------------------------------------


def test_elastic_shrink_remesh_divisor_sweep():
    """8 -> 4 -> 2 -> 1 ranks, each extent dividing the bucket count, and
    the rank-major byte rows re-stacked bit-identically at every level;
    the grid keeps its DCs; no usable extent raises."""
    from repro_torch.core.records import WireFrame
    rng = np.random.default_rng(0)
    n = 8 * 16
    frame = WireFrame.for_payload(np.zeros((1, 4), np.int32),
                                  meta=("bucket",), explicit_valid=True)
    payload = torch.from_numpy(rng.integers(0, 1 << 30, (n, 4),
                                            dtype=np.int32))
    valid = torch.from_numpy(rng.integers(0, 2, n).astype(bool))
    rows = frame.frame_rows(payload, valid=valid,
                            bucket=torch.arange(n, dtype=torch.int32) % 8)
    ranks = Ranks(8, device="cpu")
    tiles = remesh(rows, ranks)
    seen = []
    while ranks.world > 1:
        ranks = shrink_mesh(ranks, ("data",), lost_device=ranks.world // 2,
                            num_buckets=8)
        seen.append(ranks.world)
        tiles = remesh(tiles.reshape(n, -1), ranks)
        assert tiles.dtype == torch.uint8 and tiles.shape[0] == ranks.world
        assert torch.equal(tiles.reshape(n, -1), rows)
        p2, v2, _ = frame.open_rows(tiles.reshape(n, -1))
        assert torch.equal(v2, valid) and torch.equal(p2[valid],
                                                      payload[valid])
    assert seen == [4, 2, 1]
    g = shrink_mesh(Ranks(shape=(2, 4), axes=("dc", "node"), device="cpu"),
                    ("dc", "node"), lost_device=5, num_buckets=8)
    assert (g.shape, g.axes, g.device.type) == ((2, 2), ("dc", "node"),
                                                "cpu")
    assert shrink_mesh(Ranks(8, device="cpu"), ("data",), lost_device=[0, 1],
                       num_buckets=8).world == 4
    assert shrink_mesh(Ranks(8, device="cpu"), ("data",), lost_device=0,
                       num_buckets=7).world == 1
    with pytest.raises(ValueError, match="cannot shrink"):
        shrink_mesh(Ranks(1, device="cpu"), ("data",), 0, 8)
    with pytest.raises(ValueError, match="out of range"):
        shrink_mesh(Ranks(8, device="cpu"), ("data",), 8, 8)
    with pytest.raises(ValueError, match="at least one"):
        shrink_mesh(Ranks(8, device="cpu"), ("data",), [], 8)
    with pytest.raises(ValueError, match="beyond the shuffle axes"):
        shrink_mesh(Ranks(shape=(2, 4), axes=("dc", "node"), device="cpu"),
                    ("node",), 0, 8)
    with pytest.raises(ValueError, match="do not split"):
        remesh(torch.zeros(9), Ranks(2, device="cpu"))


# -- SPMDExecutor chaos against the 8-device reference --------------------------------

GRIDS = {"flat": lambda: Ranks(8, device="cpu"),
         "grid": lambda: Ranks(shape=(2, 4), axes=("dc", "node"),
                               device="cpu")}


def _twc():
    return (t_dataflow.Dataflow.source().map(_temit)
            .shuffle(by=lambda r: t_mr.default_hash(r["key"], NB),
                     num_buckets=NB)
            .reduce(_tcount))


def _info(res, plan):
    rec = res.valid_records()
    return {"counts": sorted([int(k), int(v)]
                             for k, v in zip(rec["key"], rec["value"])),
            "dropped": int(res.dropped), "recoveries": res.recoveries,
            "events": list(plan.events) if plan is not None else []}


@pytest.mark.parametrize("tag", ["flat", "grid"])
def test_spmd_chaos_matrix_matches_jax(refs, tag):
    """Both boundaries x 3 seeds: the same lost rank and resumed grid
    (events), the same multiset, the same ``dropped`` and one recovery;
    the segmented run with no fault equals the one-pass run."""
    out, _ = refs
    ex = t_dataflow.SPMDExecutor(GRIDS[tag]())
    src = {"word": matrix_words().reshape(8, -1)}
    df = _twc()
    clean = _info(ex.run(df, src), None)
    assert clean == out[f"matrix_{tag}_clean"]
    plan = t_chaos.FaultPlan(kind="none")
    seg = _info(ex.run(df, src, chaos=plan), plan)
    assert seg == out[f"matrix_{tag}_none"]
    assert seg["counts"] == clean["counts"] and seg["recoveries"] == 0
    want = sorted([int(w), c] for w, c in collections.Counter(
        matrix_words().tolist()).items())
    for phase in (0, 1):
        for seed in SEEDS:
            plan = t_chaos.FaultPlan(kind="lose_device", phase=phase,
                                     seed=seed)
            got = _info(ex.run(df, src, chaos=plan), plan)
            assert plan.fired and got["recoveries"] == 1
            assert got == out[f"matrix_{tag}_{phase}_{seed}"], (phase, seed)
            assert got["counts"] == want and got["dropped"] == 0


def test_spmd_chaos_between_two_shuffle_hops_matches_jax(refs):
    out, _ = refs
    df = (t_dataflow.Dataflow.source().map(_temit)
          .shuffle(by=lambda r: t_mr.default_hash(r["key"] * 7 + 13, NB),
                   num_buckets=NB, capacity_factor=6.0)
          .shuffle(by=lambda r: r["key"] % NB, num_buckets=NB,
                   capacity_factor=6.0)
          .reduce(_tcount))
    src = {"word": two_hop_words().reshape(8, -1)}
    ex = t_dataflow.SPMDExecutor(Ranks(8, device="cpu"))
    assert _info(ex.run(df, src), None) == out["two_hop_clean"]
    for phase in (0, 1, 2):
        for seed in (0, 1):
            plan = t_chaos.FaultPlan(kind="lose_device", phase=phase,
                                     seed=seed)
            got = _info(ex.run(df, src, chaos=plan), plan)
            assert plan.fired and got["recoveries"] == 1
            assert got == out[f"two_hop_{phase}_{seed}"], (phase, seed)


@pytest.mark.parametrize("tag", ["flat", "grid"])
def test_spmd_chaos_sort_resume_matches_jax(refs, tag):
    """A rank lost before and after the range shuffle: the same sorted
    keys, the same (key, payload) pairs, the same events; a globally
    sorted permutation of the input."""
    out, arr = refs
    keys, payload = sort_inputs()
    df = t_dataflow.Dataflow.source().sort(key=lambda r: r["key"],
                                           num_buckets=8, capacity_factor=3.0)
    src = {"key": keys.reshape(8, -1), "payload": payload.reshape(8, -1)}
    ex = t_dataflow.SPMDExecutor(GRIDS[tag]())
    plans = {"clean": None, "none": t_chaos.FaultPlan(kind="none"),
             "0_0": t_chaos.FaultPlan(kind="lose_device", phase=0, seed=0),
             "0_1": t_chaos.FaultPlan(kind="lose_device", phase=0, seed=1),
             "1_0": t_chaos.FaultPlan(kind="lose_device", phase=1, seed=0)}
    for name, plan in plans.items():
        res = ex.run(df, src, chaos=plan)
        vr = res.valid_records()
        ref = out[f"sort_{tag}_{name}"]
        assert int(res.dropped) == ref["dropped"] == 0
        assert res.recoveries == ref["recoveries"]
        assert (list(plan.events) if plan else []) == ref["events"]
        k = arr[f"sort_{tag}_{name}_key"]
        np.testing.assert_array_equal(vr["key"], k)
        assert (np.diff(vr["key"]) >= 0).all()
        assert (keys[vr["payload"]] == vr["key"]).all()
        assert sorted(zip(vr["key"].tolist(), vr["payload"].tolist())) == \
            sorted(zip(k.tolist(), arr[f"sort_{tag}_{name}_payload"]
                       .tolist()))


def test_segmented_run_leaves_input_alone_and_reuses_sub_executors():
    """The records handed to a chaos run are not modified, and a resumed
    run on the CPU hands back tensors of the survivor grid."""
    keys, payload = sort_inputs()
    src = {"key": torch.from_numpy(keys.reshape(8, -1).copy()),
           "payload": torch.from_numpy(payload.reshape(8, -1).copy())}
    before = {k: v.clone() for k, v in src.items()}
    df = t_dataflow.Dataflow.source().sort(key=lambda r: r["key"],
                                           num_buckets=8, capacity_factor=3.0)
    ex = t_dataflow.SPMDExecutor(Ranks(8, device="cpu"))
    res = ex.run(df, src, chaos=t_chaos.FaultPlan(kind="lose_device",
                                                  phase=0, seed=0))
    assert res.valid.shape[0] == 4 and res.records["key"].shape[0] == 4
    for k in src:
        assert torch.equal(src[k], before[k])
    # the executor keeps one sub-executor per grid and reuses it
    ex.run(df, src, chaos=t_chaos.FaultPlan(kind="lose_device", phase=0,
                                            seed=1))
    assert sorted(k[0] for k in ex._sub_execs) == [(4,), (8,)]
