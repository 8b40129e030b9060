"""The port's Sphere segment scheduler (``repro_torch.sphere.scheduler``)
against the JAX package's: the paper's rules 1-3, fault tolerance and
straggler speculation (§3.5), the cases of ``tests/test_scheduler.py``.

Each case runs as one script on both packages with the same segments,
SPEs and replica locations; the stats, the schedule events, and each
segment's status, attempts and completing SPE must be equal, and the port
must pass the reference test's own assertions.
"""

import dataclasses
import types

import pytest

import repro.core.stream as j_stream
import repro.sector.topology as j_topology
import repro.sphere.scheduler as j_scheduler
import repro_torch.core.stream as t_stream
import repro_torch.sector.topology as t_topology
import repro_torch.sphere.scheduler as t_scheduler


def _ns(scheduler, topology, stream):
    return types.SimpleNamespace(
        SegmentScheduler=scheduler.SegmentScheduler,
        SegStatus=scheduler.SegStatus, SPEState=scheduler.SPEState,
        DeadlineHeap=scheduler.DeadlineHeap,
        NodeAddress=topology.NodeAddress, SegmentInfo=stream.SegmentInfo,
        SphereStream=stream.SphereStream)


PKGS = {"jax": _ns(j_scheduler, j_topology, j_stream),
        "torch": _ns(t_scheduler, t_topology, t_stream)}


def make_segments(S, n, files=4, recs=1000):
    return [S.SegmentInfo(i, f"/d/f{i % files:02d}", 0, recs)
            for i in range(n)]


def locations(S, files=4):
    return {f"/d/f{i:02d}": [S.NodeAddress(0, i % 2, i)]
            for i in range(files)}


def observe(s, stats):
    """What a run shows: stats, events, and every segment's outcome."""
    return (stats, [dataclasses.astuple(e) for e in s.events],
            [(seg.status.value, seg.completed_by, seg.attempts,
              seg.data_errors) for seg in s.segments])


def both(scenario):
    ref = scenario(PKGS["jax"])
    port = scenario(PKGS["torch"])
    assert port == ref
    return port


def test_all_segments_complete():
    def run(S):
        spes = [S.SPEState(i, S.NodeAddress(0, i % 2, i % 4), speed=1e3)
                for i in range(4)]
        s = S.SegmentScheduler(make_segments(S, 16), spes, locations(S))
        return observe(s, s.run())
    stats, _, _ = both(run)
    assert stats["done"] == 16 and stats["unfinished"] == 0


def test_locality_rule_prefers_colocated_spe():
    def run(S):
        spes = [S.SPEState(0, S.NodeAddress(0, 0, 0), speed=1e3),
                S.SPEState(1, S.NodeAddress(1, 1, 9), speed=1e3)]
        segs = [S.SegmentInfo(0, "/d/f00", 0, 100)]
        s = S.SegmentScheduler(segs, spes, locations(S))
        return observe(s, s.run())
    _, _, segs = both(run)
    assert segs[0][1] == 0


def test_straggler_speculation_wins():
    def run(S):
        out = []
        for speculate in (True, False):
            spes = [S.SPEState(0, S.NodeAddress(0, 0, 0), speed=1e3),
                    S.SPEState(1, S.NodeAddress(0, 0, 1), speed=10.0)]
            s = S.SegmentScheduler(make_segments(S, 4, files=1), spes,
                                   locations(S, 1), speculate=speculate)
            out.append(observe(s, s.run()))
        return out
    (stats, events, _), (st2, _, _) = both(run)
    assert stats["done"] == 4
    assert any(e[1] == "duplicate" for e in events)
    assert stats["makespan"] < 4 * 1000 / 10.0
    assert stats["makespan"] <= st2["makespan"]


def test_spe_crash_reassigns_segment():
    def run(S):
        spes = [S.SPEState(0, S.NodeAddress(0, 0, 0), speed=100.0,
                           fail_at=0.5),
                S.SPEState(1, S.NodeAddress(0, 0, 1), speed=100.0)]
        s = S.SegmentScheduler(make_segments(S, 6), spes, locations(S),
                               timeout=1.0)
        return observe(s, s.run())
    stats, events, segs = both(run)
    assert stats["done"] == 6
    assert any(e[1] == "timeout" for e in events)
    assert all(seg[1] in (0, 1) for seg in segs)


def test_data_error_reported_not_retried_forever():
    def run(S):
        spes = [S.SPEState(i, S.NodeAddress(0, 0, i), speed=1e3)
                for i in range(2)]
        s = S.SegmentScheduler(make_segments(S, 8), spes, locations(S),
                               max_data_errors=2)
        return observe(s, s.run(fail_segments={3}))
    stats, _, segs = both(run)
    assert stats["data_errors"] == 1
    assert stats["done"] == 7
    assert segs[3][0] == "data_error"
    assert segs[3][2] <= 3


def test_static_assignment_partition():
    def run(S):
        spes = [S.SPEState(i, S.NodeAddress(0, i % 2, i), speed=1e3)
                for i in range(3)]
        s = S.SegmentScheduler(make_segments(S, 10), spes, locations(S))
        return s.static_assignment()
    a = both(run)
    assert sorted(i for v in a.values() for i in v) == list(range(10))
    loads = [len(v) for v in a.values()]
    assert max(loads) - min(loads) <= 1


def test_segment_planning_bounds():
    files = [("/f/a", 1000), ("/f/b", 500)]

    def run(S):
        segs = S.SphereStream.plan_segments(1500, record_bytes=100,
                                            files=files, s_min=10_000,
                                            s_max=20_000, num_spes=4)
        return [dataclasses.astuple(s) for s in segs]
    segs = both(run)
    assert sum(s[3] for s in segs) == 1500
    for _, path, off, n in segs:
        assert n <= 200 and path in ("/f/a", "/f/b")
        assert off + n <= dict(files)[path]


def test_deadline_heap_pops_due_in_order():
    def run(S):
        h = S.DeadlineHeap()
        for d, item in ((3.0, "c"), (1.0, "a"), (2.0, "b"), (1.0, "a2")):
            h.push(d, item)
        first = h.pop_due(1.5)
        return first, h.peek(), len(h), h.pop_due(10.0)
    first, peek, size, rest = both(run)
    assert first == [(1.0, "a"), (1.0, "a2")] and peek == 2.0 and size == 2
    assert rest == [(2.0, "b"), (3.0, "c")]


@pytest.mark.parametrize("n_segs,n_spes,crash", [
    (1, 1, []), (5, 2, [0]), (12, 3, [0, 1]), (24, 6, [2, 5]),
    (7, 4, [3]), (16, 5, [0, 4]), (24, 1, [0])])
def test_completion_under_failures(n_segs, n_spes, crash):
    """As long as >= 1 SPE survives, every segment completes exactly once
    (the reference's hypothesis property, on fixed draws)."""
    def run(S):
        spes = []
        for i in range(n_spes):
            fail = 1.0 if i in crash and i < n_spes - 1 else None
            spes.append(S.SPEState(i, S.NodeAddress(0, i % 2, i),
                                   speed=100.0, fail_at=fail))
        s = S.SegmentScheduler(make_segments(S, n_segs), spes, locations(S),
                               timeout=0.5)
        return observe(s, s.run())
    stats, _, segs = both(run)
    assert stats["done"] == n_segs
    assert all(seg[1] is not None for seg in segs)
