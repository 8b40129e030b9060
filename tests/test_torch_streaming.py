"""The port's streaming layer — ``TenantQueue`` and ``StreamExecutor`` —
against the JAX package, on the CPU.

- Every ``TenantQueue`` case of ``tests/test_streaming.py`` runs on both
  packages (the queue is copied, framework-free) with the same ticket
  order and the same ``stats()``.
- ``StreamExecutor`` on one rank runs in-process against the reference on
  one device: carry snapshots, cache counters, the exactly-once requeue,
  bad requests and the schema check.
- On ``Ranks(8, device="cpu")`` and the ``(dc, node) = (2, 4)`` grid the
  port is held against the JAX package on 8 virtual devices (the
  session-shared subprocess of ``tests/test_torch_jax_stream_refs.py``):
  stream == batch, a mid-stream lost rank, streamed sort batches,
  per-stage traces and the stream-chaos soak of
  ``benchmarks/stream_chaos_bench.py`` at its own size, whose final
  snapshot and events log must equal the reference's.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.mapreduce as j_mr
import repro.core.retry as j_retry
import repro.sphere.chaos as j_chaos
import repro.sphere.dataflow as j_dataflow
import repro.sphere.scheduler as j_scheduler
import repro.sphere.streaming as j_streaming
import repro_torch.core.mapreduce as t_mr
import repro_torch.core.retry as t_retry
import repro_torch.sphere.chaos as t_chaos
import repro_torch.sphere.dataflow as t_dataflow
import repro_torch.sphere.scheduler as t_scheduler
import repro_torch.sphere.streaming as t_streaming
from repro_torch.comm import Ranks
from repro_torch.obs.trace import Tracer

from torch_stream_soak import pairs, port_soak, stream_wordcount
from test_torch_jax_stream_refs import (K, MB, NB, device_loss_words,
                                        matrix_words, sort_batches,
                                        stream_references, stream_words)

QUEUES = {"jax": (j_streaming, j_scheduler), "port": (t_streaming,
                                                      t_scheduler)}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return stream_references(tmp_path_factory)


# -- TenantQueue on both packages ------------------------------------------------


def _weighted_fair_share(mod, sched):
    weights = {"a": 1.0, "b": 3.0, "c": 4.0}
    q = mod.TenantQueue(quantum=1.0, capacity=10_000)
    for t, w in weights.items():
        q.register(t, weight=w)
    for _ in range(600):
        for t in weights:
            q.admit(t, payload=t, cost=1, now=0.0)
    order = []
    served = collections.Counter()
    for _ in range(100):
        for tk in q.acquire(8, now=0.0):
            q.complete(tk, now=1.0)
            served[tk.tenant] += 1
            order.append(tk.req_id)
    total = sum(served.values())
    assert total == 800
    for t, w in weights.items():
        rel = (served[t] / total) / (w / sum(weights.values()))
        assert 0.9 <= rel <= 1.1, (t, rel)
    return order, q.stats()


def _uneven_costs(mod, sched):
    q = mod.TenantQueue(quantum=8.0, capacity=10_000)
    q.register("small", weight=1.0)
    q.register("big", weight=1.0)
    for _ in range(400):
        q.admit("small", "s", cost=2, now=0.0)
    for _ in range(100):
        q.admit("big", "b", cost=8, now=0.0)
    order, served = [], collections.Counter()
    for _ in range(40):
        for tk in q.acquire(32, now=0.0):
            q.complete(tk, now=1.0)
            served[tk.tenant] += tk.cost
            order.append(tk.req_id)
    assert sum(served.values()) == 40 * 32
    assert 0.45 <= served["small"] / (40 * 32) <= 0.55
    return order, q.stats()


def _strict_priority(mod, sched):
    q = mod.TenantQueue(quantum=16.0)
    q.register("urgent", priority=0)
    q.register("bulk", priority=1)
    for _ in range(5):
        q.admit("bulk", "b", cost=1, now=0.0)
    for _ in range(3):
        q.admit("urgent", "u", cost=1, now=0.0)
    got = [tk.tenant for tk in q.acquire(4, now=0.0)]
    assert got == ["urgent", "urgent", "urgent", "bulk"]
    q.admit("urgent", "u", cost=3, now=0.0)
    assert q.acquire(2, now=0.0) == []
    assert q.depth("bulk") == 4
    return got, q.stats()


def _backpressure(mod, sched):
    q = mod.TenantQueue(capacity=2)
    q.register("t")
    q.admit("t", 1, now=0.0)
    q.admit("t", 2, now=0.0)
    with pytest.raises(mod.QueueFull, match="queue full"):
        q.admit("t", 3, now=0.0)
    assert q.stats()["t"]["rejected"] == 1 and q.depth("t") == 2
    order = [tk.req_id for tk in q.acquire(2, now=0.0)]
    for tk in q.pending_items():
        q.complete(tk, now=0.0)
    q.admit("t", 3, now=0.0)
    return order, q.stats()


def _timeout_requeue(mod, sched):
    q = mod.TenantQueue(quantum=16.0)
    q.register("t")
    first = q.admit("t", "first", now=0.0)
    late = q.admit("t", "late", cost=1, timeout=5.0, now=0.0)
    assert q.expire(4.9) == []
    assert q.expire(5.1) == [late]
    assert late.requeues == 1 and late.deadline == pytest.approx(10.1)
    assert q.stats()["t"]["timeouts"] == 1
    assert q.acquire(1, now=5.1) == [late]
    assert q.complete(late, now=5.2)
    assert first.status == sched.SegStatus.PENDING
    return [late.req_id, first.req_id], q.stats()


def _exactly_once(mod, sched):
    q = mod.TenantQueue(quantum=16.0)
    q.register("t")
    tk = q.admit("t", "p", now=0.0)
    (got,) = q.acquire(1, now=0.0)
    assert got is tk and tk.status == sched.SegStatus.RUNNING
    assert q.requeue(tk, now=1.0)
    assert tk.status == sched.SegStatus.PENDING and q.depth("t") == 1
    assert q.complete(tk, now=2.0)
    assert q.depth("t") == 0 and q.acquire(1, now=2.0) == []
    assert not q.complete(tk, now=3.0)
    assert q.stats()["t"]["delivered"] == 1
    tk2 = q.admit("t", "p2", timeout=1.0, now=10.0)
    q.acquire(1, now=10.0)
    assert q.expire(20.0) == []
    assert tk2.status == sched.SegStatus.RUNNING
    return [tk.req_id, tk2.req_id], q.stats()


def _max_requeues(mod, sched):
    q = mod.TenantQueue(quantum=16.0, max_requeues=2)
    q.register("t")
    tk = q.admit("t", "p", timeout=1.0, now=0.0)
    assert q.expire(1.5) == [tk]
    assert q.expire(3.0) == [tk]
    assert q.expire(5.0) == []
    assert tk.status == sched.SegStatus.DATA_ERROR and q.depth("t") == 0
    st = q.stats()["t"]
    assert st["failed"] == 1 and st["timeouts"] == 3
    assert not q.complete(tk, now=6.0)
    return [tk.requeues], q.stats()


def _retry_backoff(mod, sched):
    retry = (j_retry if mod is j_streaming else t_retry).RetryPolicy
    q = mod.TenantQueue(quantum=1.0, timeout=4.0, max_requeues=5,
                        retry_policy=retry(base=0.25, cap=2.0, jitter=0.1,
                                           seed=3))
    q.register("a")
    q.register("b")
    tks = [q.admit(t, t, now=0.0) for t in "abab"]
    order = [tk.req_id for tk in q.acquire(2, now=0.0)]
    q.requeue(tks[0], now=1.0)
    order += [tk.req_id for tk in q.acquire(4, now=1.0)]
    order += [tk.req_id for tk in q.acquire(4, now=2.0)]
    return order + [tks[0].not_before, tks[0].deadline], q.stats()


@pytest.mark.parametrize("case", [
    _weighted_fair_share, _uneven_costs, _strict_priority, _backpressure,
    _timeout_requeue, _exactly_once, _max_requeues, _retry_backoff],
    ids=lambda f: f.__name__.lstrip("_"))
def test_tenant_queue_matches_jax(case):
    got = {name: case(*mods) for name, mods in QUEUES.items()}
    assert got["port"] == got["jax"]


def test_deadline_heap_pop_due_order_and_peek():
    h = t_scheduler.DeadlineHeap()
    h.push(5.0, "c")
    h.push(1.0, "a")
    h.push(3.0, "b")
    assert len(h) == 3 and h.peek() == 1.0
    assert h.pop_due(0.5) == []
    assert [x for _, x in h.pop_due(3.0)] == ["a", "b"]
    assert [x for _, x in h.pop_due(100.0)] == ["c"] and h.peek() is None


# -- StreamExecutor on one rank, in-process against one JAX device ---------------


def _jwordcount(nb):
    def emit(rec):
        return {"key": rec["x"].astype(jnp.int32) % 7,
                "value": jnp.ones_like(rec["x"], jnp.int32)}

    def count(rec, valid):
        k, v, d = j_mr.reduce_by_key_sum(rec["key"], rec["value"], valid)
        return {"key": k, "value": v}, k >= 0, d

    return (j_dataflow.Dataflow.stream_source().map(emit)
            .shuffle(by=lambda r: j_mr.default_hash(r["key"], nb),
                     num_buckets=nb)
            .reduce(count))


def _twordcount(nb):
    def emit(rec):
        return {"key": rec["x"].to(torch.int32) % 7,
                "value": torch.ones_like(rec["x"], dtype=torch.int32)}

    def count(rec, valid):
        k, v, d = t_mr.reduce_by_key_sum(rec["key"], rec["value"], valid)
        return {"key": k, "value": v}, k >= 0, d

    return (t_dataflow.Dataflow.stream_source().map(emit)
            .shuffle(by=lambda r: t_mr.default_hash(r["key"], nb),
                     num_buckets=nb)
            .reduce(count))


def _executors(micro_batch=16, **kw):
    """One reference StreamExecutor on one JAX device, one port executor
    on one CPU rank; ``kw`` may hold a ``chaos`` factory."""
    chaos = kw.pop("chaos", None)
    j = j_streaming.StreamExecutor(
        j_dataflow.SPMDExecutor(jax.make_mesh((1,), ("data",))),
        _jwordcount(1), micro_batch=micro_batch,
        chaos=chaos(j_chaos) if chaos else None, **kw)
    t = t_streaming.StreamExecutor(
        t_dataflow.SPMDExecutor(Ranks(1, device="cpu")), _twordcount(1),
        micro_batch=micro_batch, chaos=chaos(t_chaos) if chaos else None,
        **kw)
    return j, t


def _snapshot(snap):
    return {int(k): int(v) for k, v in zip(snap["key"], snap["value"])}


def test_stream_executor_carry_and_cache_counters():
    j, t = _executors(carry_capacity=8, clock=lambda: 0.0)
    rng = np.random.default_rng(0)
    seen = []
    for step in range(5):
        x = rng.integers(0, 100, size=16 if step % 2 else 10)
        seen.append(x.astype(np.int32))
        for ex in (j, t):
            ex.submit({"x": seen[-1]})
        jb, tb = j.step(), t.step()
        assert len(tb.delivered) == 1 and tb.dropped == jb.dropped == 0
        assert _snapshot(t.carry_state()) == _snapshot(j.carry_state())
        want = collections.Counter(np.concatenate(seen).astype(int) % 7)
        assert _snapshot(t.carry_state()) == dict(want), step
        assert sorted(_snapshot(tb.valid_records()).items()) == \
            sorted(_snapshot(jb.valid_records()).items())
    info = t.inner.cache_info()
    assert info.misses == 1 and info.hits == 4 and info.evictions == 0
    st, sj = t.stats(), j.stats()
    for k in ("steps", "records_in", "batch_failures", "recoveries"):
        assert st[k] == sj[k]
    assert st["cache"] == sj["cache"]
    assert st["tenants"] == sj["tenants"]
    assert st["tenants"]["default"]["delivered"] == 5
    # the carry's schema probe launches nothing on the CPU
    assert sum(t.init_launches.values()) == 0
    # the sealed boundary of the last step serializes as the reference's
    assert t._checkpoint.to_bytes() == j._checkpoint.to_bytes()


def test_stream_executor_failed_batch_requeue_exactly_once():
    j, t = _executors(carry_capacity=8, clock=lambda: 0.0,
                      chaos=lambda c: c.ChaosSchedule(
                          [c.FaultPlan(kind="lose_batch", at_batch=0)]))
    rng = np.random.default_rng(1)
    xs = [rng.integers(0, 50, size=16).astype(np.int32) for _ in range(3)]
    out = {}
    for name, ex in (("jax", j), ("port", t)):
        tickets = [ex.submit({"x": x}) for x in xs]
        lost = ex.step()
        assert ex.chaos.fired and len(ex.chaos.events) == 1
        assert lost.delivered == [] and len(lost.requeued) == 1
        assert lost.requeued[0].requeues == 1
        delivered = [tk.req_id for b in ex.drain() for tk in b.delivered]
        assert sorted(delivered) == sorted(tk.req_id for tk in tickets)
        out[name] = (delivered, list(ex.chaos.events),
                     _snapshot(ex.carry_state()), ex.stats()["tenants"],
                     ex.stats()["batch_failures"])
    assert out["port"] == out["jax"]
    want = collections.Counter(np.concatenate(xs).astype(int) % 7)
    assert out["port"][2] == dict(want) and out["port"][4] == 1


def test_stream_executor_rejects_bad_requests():
    msgs = {}
    for name, ex in zip(("jax", "port"), _executors(carry_capacity=8)):
        got = []
        with pytest.raises(ValueError, match="micro-batch") as e:
            ex.submit({"x": np.zeros(17, np.int32)})
        got.append(str(e.value))
        with pytest.raises(ValueError, match="micro-batch"):
            ex.submit({"x": np.zeros(0, np.int32)})
        ex.submit({"x": np.zeros(4, np.int32)})
        with pytest.raises(ValueError, match="schema"):
            ex.submit({"x": np.zeros(4, np.float32)})
        msgs[name] = got
    assert msgs["port"] == msgs["jax"]
    t = _executors()[1]
    with pytest.raises(ValueError, match="stream_source"):
        t_streaming.StreamExecutor(
            t.inner, t_dataflow.Dataflow.source().map(lambda r: r),
            micro_batch=16)
    with pytest.raises(ValueError, match="divisible"):
        t_streaming.StreamExecutor(
            t_dataflow.SPMDExecutor(Ranks(8, device="cpu")),
            _twordcount(8), micro_batch=12)


def test_stream_carry_requires_schema_preserving_reduce():
    def bad_reduce(rec, valid):       # changes the value dtype: not feedable
        return ({"key": rec["key"], "value": rec["value"].to(torch.float32)},
                valid, torch.zeros((), dtype=torch.int32))

    df = (t_dataflow.Dataflow.stream_source()
          .map(lambda r: {"key": r["x"].to(torch.int32),
                          "value": torch.ones_like(r["x"],
                                                   dtype=torch.int32)})
          .shuffle(by=lambda r: r["key"] % 1, num_buckets=1)
          .reduce(bad_reduce))
    inner = t_dataflow.SPMDExecutor(Ranks(1, device="cpu"))
    ex = t_streaming.StreamExecutor(inner, df, micro_batch=16,
                                    carry_capacity=4)
    ex.submit({"x": np.zeros(8, np.int32)})
    with pytest.raises(ValueError, match="schema-preserving"):
        ex.step()
    nodf = (t_dataflow.Dataflow.stream_source().map(lambda r: r)
            .shuffle(by=lambda r: r["x"] % 1, num_buckets=1))
    with pytest.raises(ValueError, match="reduce"):
        t_streaming.StreamExecutor(inner, nodf, micro_batch=16,
                                   carry_capacity=4)


def test_compact_carry_matches_a_stable_argsort():
    """The prefix-sum compaction picks the rows of ``argsort(~valid,
    stable=True)[:cap]`` per rank, drops and counts the overflow, and pads
    a short input."""
    from repro_torch.sphere.dataflow import _compact_carry
    rng = np.random.default_rng(5)
    for n, cap in ((40, 16), (16, 16), (10, 16), (33, 1)):
        valid = torch.from_numpy(rng.random((4, n)) < 0.6)
        rec = {"k": torch.from_numpy(rng.integers(0, 99, (4, n))
                                     .astype(np.int32)),
               "v": torch.from_numpy(rng.random((4, n, 2)))}
        c_rec, c_valid, dropped = _compact_carry(rec, valid, cap)
        want_drop = 0
        for r in range(4):
            v = valid[r].numpy()
            k = np.concatenate([rec["k"][r].numpy(),
                                np.zeros(max(cap - n, 0), np.int32)])
            vv = np.concatenate([v, np.zeros(max(cap - n, 0), bool)])
            order = np.argsort(~vv, kind="stable")[:cap]
            np.testing.assert_array_equal(c_rec["k"][r].numpy(), k[order])
            nv = int(v.sum())
            np.testing.assert_array_equal(c_valid[r].numpy(),
                                          np.arange(cap) < min(nv, cap))
            want_drop += max(nv - cap, 0)
            if n >= cap:
                np.testing.assert_array_equal(
                    c_rec["v"][r].numpy(), rec["v"][r].numpy()[order])
        assert int(dropped) == want_drop


# -- 8 ranks and the (dc, node) grid against 8 JAX devices -------------------------


GRIDS = {"flat": lambda: Ranks(8, device="cpu"),
         "grid": lambda: Ranks(shape=(2, 4), axes=("dc", "node"),
                               device="cpu")}


@pytest.mark.parametrize("tag", ["flat", "grid"])
def test_stream_vs_batch_matches_jax(refs, tag):
    """K micro-batches with carry end at the reference's snapshot, equal
    to the one-shot run of the concatenation, with one cache miss; the
    last boundary's checkpoint bytes are the reference's."""
    out, arr = refs
    words = stream_words()
    ex = t_streaming.StreamExecutor(t_dataflow.SPMDExecutor(GRIDS[tag]()),
                                    stream_wordcount(), micro_batch=MB,
                                    carry_capacity=32)
    for i in range(K):
        ex.submit({"word": words[i * MB:(i + 1) * MB]})
        b = ex.step()
    ref = out[f"stream_{tag}"]
    assert pairs(ex.carry_state()) == ref["counts"]
    assert pairs(b.valid_records()) == ref["last_batch"]
    assert ex.inner.cache_info()._asdict() == ref["cache"]
    assert ex.inner.cache_info().misses == 1
    want = sorted([int(w), c] for w, c in collections.Counter(
        words.tolist()).items())
    assert ref["counts"] == want
    one = t_dataflow.SPMDExecutor(GRIDS[tag]()).run(
        stream_wordcount(), {"word": words.reshape(8, -1)})
    assert pairs(one.valid_records()) == want
    assert np.frombuffer(ex._checkpoint.to_bytes(), np.uint8).tobytes() == \
        arr[f"stream_{tag}_carry_bytes"].tobytes()


def test_stream_mid_batch_device_loss_matches_jax(refs):
    """lose_device at batch 1: 8 -> 4 ranks, the carry re-stacked from the
    boundary checkpoint, one more cache miss, the in-flight ticket
    requeued once and delivered once — the reference's events, batches,
    ticket latencies and snapshot."""
    ref = refs[0]["device_loss"]
    sched = t_chaos.ChaosSchedule(
        [t_chaos.FaultPlan(kind="lose_device", at_batch=1)], seed=5)
    queue = t_streaming.TenantQueue(quantum=float(MB))
    vclock = {"now": 0.0}
    ex = t_streaming.StreamExecutor(
        t_dataflow.SPMDExecutor(Ranks(8, device="cpu")),
        stream_wordcount(), micro_batch=MB, carry_capacity=32,
        queue=queue, clock=lambda: vclock["now"], chaos=sched)
    words = device_loss_words()
    tickets = [ex.submit({"word": words[i * MB:(i + 1) * MB]})
               for i in range(5)]
    batches, step = [], 0
    while queue.pending():
        vclock["now"] = float(step)
        b = ex.step()
        if b is not None:
            batches.append([[t.req_id for t in b.delivered],
                            [t.req_id for t in b.requeued], b.dropped])
        step += 1
    st = ex.stats()
    assert list(sched.events) == ref["events"] and len(sched.events) == 2
    assert batches == ref["batches"]
    assert st["cache"] == ref["cache"] and st["cache"]["misses"] == 2
    assert st["recoveries"] == ref["recoveries"] == 1
    assert ex.inner.axis_size == ref["axis_size"] == 4
    assert [[t.requeues, t.attempts, t.completed_at]
            for t in tickets] == ref["tickets"]
    assert st["tenants"] == ref["tenants"]
    assert pairs(ex.carry_state()) == ref["counts"]


def test_streamed_sort_batches_match_jax(refs):
    out, arr = refs
    df = t_dataflow.Dataflow.stream_source().sort(
        key=lambda r: r["key"], num_buckets=8, capacity_factor=3.0)
    ex = t_streaming.StreamExecutor(
        t_dataflow.SPMDExecutor(Ranks(8, device="cpu")), df,
        micro_batch=8 * 64)
    for i, keys in enumerate(sort_batches()):
        ex.submit({"key": keys, "payload": np.arange(8 * 64,
                                                     dtype=np.int32)})
        b = ex.step()
        assert b.dropped == 0
        vr = b.valid_records()
        np.testing.assert_array_equal(vr["key"], arr[f"sorted_{i}_key"])
        np.testing.assert_array_equal(np.sort(vr["key"]), np.sort(keys))
        assert (keys[vr["payload"]] == vr["key"]).all()
        assert sorted(zip(vr["key"].tolist(), vr["payload"].tolist())) == \
            sorted(zip(arr[f"sorted_{i}_key"].tolist(),
                       arr[f"sorted_{i}_payload"].tolist()))
    assert ex.inner.cache_info()._asdict() == out["sorted_cache"]


def test_trace_stages_matches_one_pass_and_jax(refs):
    """One span per stage (and per hop), the same records as the one-pass
    run and the reference's, and no carry with it."""
    ref = refs[0]["staged"]
    df = (t_dataflow.Dataflow.source().map(stream_wordcount().stages[0].fn)
          .shuffle(by=lambda r: t_mr.default_hash(r["key"], NB),
                   num_buckets=NB)
          .reduce(stream_wordcount().stages[2].fn))
    src = {"word": matrix_words().reshape(8, -1)}
    ex = t_dataflow.SPMDExecutor(Ranks(8, device="cpu"))
    tr = Tracer()
    staged = ex.run(df, src, trace=tr, trace_stages=True)
    one = ex.run(df, src)
    assert pairs(staged.valid_records()) == pairs(one.valid_records()) \
        == ref["counts"]
    assert int(staged.dropped) == int(one.dropped) == ref["dropped"]
    spans = sorted(sp.name for sp in tr.buffer.spans()
                   if sp.name.startswith(("stage[", "hop[")))
    assert spans == ref["spans"] == ["hop[1]:shuffle", "stage[0]:map",
                                     "stage[2]:reduce"]
    hop = next(sp for sp in tr.buffer.spans() if sp.name == "hop[1]:shuffle")
    assert hop.attrs["wire_bytes_per_device"] > 0
    with pytest.raises(ValueError, match="trace_stages"):
        ex.run(df, src, trace=tr, trace_stages=True,
               carry=({"key": torch.zeros((8, 2), dtype=torch.int32),
                       "value": torch.zeros((8, 2), dtype=torch.int32)},
                      torch.zeros((8, 2), dtype=torch.bool)))


# -- the stream-chaos soak ------------------------------------------------------


@pytest.mark.parametrize("chaos", [True, False], ids=["storm", "clean"])
def test_stream_chaos_soak_matches_jax(refs, chaos):
    """The soak at the reference's own size: the same events log (every
    victim), the same final snapshot, the same step, requeue, recovery,
    detector and master counts, and cache misses 2 with the storm (warm-up
    + one shrink) and 1 without."""
    ref = refs[0]["soak" if chaos else "soak_clean"]
    got = port_soak(chaos, device="cpu")
    for k, v in got.items():
        if k == "cache":
            for c in ("hits", "misses", "evictions"):
                assert v[c] == ref[k][c], (k, c)
        else:
            assert v == ref[k], k
    assert got["max_deliveries_per_request"] == 1
    assert got["failed"] == 0 and got["dropped"] == 0
    assert ref["stream_equals_batch"]
    if chaos:
        assert got["faults_fired"] == 4 and got["recoveries"] == 2
        assert got["cache"]["misses"] == 2 and got["end_devices"] == 4
        assert got["steps"] >= 30
    else:
        assert got["cache"]["misses"] == 1 and got["end_devices"] == 8
