"""The port's Sector (``repro_torch.sector``) against the JAX package's.

Every case of ``tests/test_sector.py`` that runs on Sector alone, and the
``SectorClient.recover`` and ``RetryPolicy`` cases of
``tests/test_retry.py``, run as one script on both packages, each in its
own deployment under ``tmp_path``, with the same inputs. The observable
results — ``FileMeta`` (path, size, md5, replica set), placements,
recovered replica sets, stats, detector states and event logs, errors —
must be equal, and the port must pass the reference test's own
assertions. (``test_storage_mode_read_amplification`` drives a benchmark
of the JAX package and has no port counterpart.)
"""

import dataclasses
import hashlib
import types

import pytest

import repro.core.retry as j_retry
import repro.sector as j_sector
import repro.sector.topology as j_topology
import repro.sector.transport as j_transport
import repro_torch.core.retry as t_retry
import repro_torch.sector as t_sector
import repro_torch.sector.topology as t_topology
import repro_torch.sector.transport as t_transport


def _ns(sector, topology, transport, retry):
    ns = {k: getattr(sector, k) for k in sector.__all__}
    ns.update(spread_choice=topology.spread_choice, transport=transport,
              RetryPolicy=retry.RetryPolicy)
    return types.SimpleNamespace(**ns)


PKGS = {"jax": _ns(j_sector, j_topology, j_transport, j_retry),
        "torch": _ns(t_sector, t_topology, t_transport, t_retry)}


def both(tmp_path, scenario, *args, **kwargs):
    """Run ``scenario(S, root, ...)`` on both packages; return (ref, port)
    after asserting their observables are equal."""
    ref = scenario(PKGS["jax"], tmp_path / "jax", *args, **kwargs)
    port = scenario(PKGS["torch"], tmp_path / "torch", *args, **kwargs)
    assert port == ref
    return ref, port


def meta(m):
    """A ``FileMeta`` as a comparable tuple (replica set sorted)."""
    if m is None:
        return None
    d = dataclasses.asdict(m)
    d["locations"] = sorted(d["locations"])
    return tuple(sorted(d.items()))


def index(master):
    return {p: meta(m) for p, m in sorted(master.index.items())}


def make_deployment(S, root, pods=2, racks=2, nodes=3, replication=3,
                    block_mode=False):
    sec = S.SecurityServer()
    sec.add_user("u", "pw")
    sec.add_user("reader", "pw2", acls=[("/public", "r")])
    sec.allow_slaves("10.1.0.0/16")
    m = S.Master(sec, replication_factor=replication, block_mode=block_mode,
                 block_size=64)
    topo = S.Topology(pods=pods, racks=racks, nodes_per_rack=nodes)
    for i, addr in enumerate(topo.all_addresses()):
        m.register_slave(S.SlaveNode(i, addr, str(root / f"s{i}"),
                                     ip=f"10.1.0.{i}"))
    return sec, m


def test_upload_download_roundtrip(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root)
        c = S.SectorClient(m, "u", "pw", client_addr=S.NodeAddress(0, 0, 0))
        data = b"x" * 10_000
        got = meta(c.upload("/d/a.dat", data))
        assert c.download("/d/a.dat") == data
        return got, index(m), m.stats
    ref, _ = both(tmp_path, run)
    assert dict(ref[0])["size"] == 10_000


def test_replication_daemon_reaches_factor_and_spreads(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root)
        c = S.SectorClient(m, "u", "pw")
        c.upload("/d/a.dat", b"payload" * 100)
        made = S.ReplicationDaemon(m).run_until_stable()
        locs = m.lookup("/d/a.dat").locations
        pods = {m.slaves[s].address.pod for s in locs}
        return made, index(m), sorted(pods)
    (_, idx, pods), _ = both(tmp_path, run)
    assert len(dict(idx["/d/a.dat"])["locations"]) == 3
    assert len(pods) > 1                   # topology-aware placement


def test_slave_failure_rereplicates_and_download_survives(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root)
        c = S.SectorClient(m, "u", "pw")
        data = b"abc" * 1000
        c.upload("/d/a.dat", data)
        d = S.ReplicationDaemon(m)
        d.run_until_stable()
        victim = next(iter(m.lookup("/d/a.dat").locations))
        m.slaves[victim].kill(wipe=True)
        d.run_until_stable()
        live = [s for s in m.lookup("/d/a.dat").locations
                if m.slaves[s].alive]
        assert c.download("/d/a.dat") == data
        return victim, sorted(live), index(m), m.stats
    (_, live, _, _), _ = both(tmp_path, run)
    assert len(live) >= 3


def test_metadata_scan_recovery(tmp_path):
    def run(S, root):
        sec, m = make_deployment(S, root)
        c = S.SectorClient(m, "u", "pw")
        c.upload("/d/a.dat", b"a" * 100)
        c.upload("/d/b.dat", b"b" * 200)
        S.ReplicationDaemon(m).run_until_stable()
        m2 = S.Master(sec, replication_factor=3)
        for s in m.slaves.values():
            m2.register_slave(s)
        return index(m2)
    idx, _ = both(tmp_path, run)
    assert set(idx) == {"/d/a.dat", "/d/b.dat"}
    assert len(dict(idx["/d/a.dat"])["locations"]) == 3
    assert dict(idx["/d/b.dat"])["size"] == 200


def test_security_acl_and_ip(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root)
        with pytest.raises(S.AccessDenied) as wrong_pw:
            S.SectorClient(m, "u", "wrong")
        reader = S.SectorClient(m, "reader", "pw2")
        with pytest.raises(S.AccessDenied) as read_only:
            reader.upload("/public/x", b"nope")  # read-only ACL
        with pytest.raises(S.AccessDenied) as no_acl:
            m.download(reader.session_id, "/private/y")
        writer = S.SectorClient(m, "u", "pw")
        writer.upload("/public/x", b"data")
        return ([str(e.value) for e in (wrong_pw, read_only, no_acl)],
                reader.download("/public/x"))
    (_, got), _ = both(tmp_path, run)
    assert got == b"data"


def test_slave_ip_allowlist(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root)
        rogue = S.SlaveNode(99, S.NodeAddress(0, 0, 99), str(root / "rogue"),
                            ip="192.168.1.1")
        with pytest.raises(S.AccessDenied) as e:
            m.register_slave(rogue)
        return str(e.value), sorted(m.slaves)
    both(tmp_path, run)


def test_ip_restricted_user(tmp_path):
    def run(S, root):
        sec, m = make_deployment(S, root)
        sec.add_user("locked", "pw", ip_ranges=["10.5.0.0/24"])
        with pytest.raises(S.AccessDenied) as e:
            S.SectorClient(m, "locked", "pw", client_ip="10.9.9.9")
        S.SectorClient(m, "locked", "pw", client_ip="10.5.0.7")  # ok
        return str(e.value)
    both(tmp_path, run)


def test_block_mode_roundtrip(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root, block_mode=True, replication=2)
        c = S.SectorClient(m, "u", "pw")
        data = bytes(range(256)) * 4  # 1024 bytes -> 16 blocks of 64
        c.upload("/blk/a.dat", data)
        assert c.download("/blk/a.dat") == data
        return index(m)
    idx, _ = both(tmp_path, run)
    blocks = [p for p in idx if p.startswith("/blk/a.dat.blk")]
    assert len(blocks) == 16
    assert all(len(dict(idx[b])["locations"]) == 2 for b in blocks)


def test_locality_preference(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root)
        c_far = S.SectorClient(m, "u", "pw",
                               client_addr=S.NodeAddress(1, 1, 0))
        c_far.upload("/d/here.dat", b"z" * 64)
        src = m.slaves[next(iter(m.lookup("/d/here.dat").locations))]
        return src.slave_id, src.address.pod
    (_, pod), _ = both(tmp_path, run)
    assert pod == 1  # stored near the uploader


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_topology_distance_and_spread(pkg):
    S = PKGS[pkg]
    a = S.NodeAddress(0, 0, 0)
    assert S.distance(a, S.NodeAddress(0, 0, 0)) == 0
    assert S.distance(a, S.NodeAddress(0, 0, 1)) == 1
    assert S.distance(a, S.NodeAddress(0, 1, 0)) == 2
    assert S.distance(a, S.NodeAddress(1, 0, 0)) == 3
    pick = S.spread_choice(
        [S.NodeAddress(0, 0, 1), S.NodeAddress(0, 1, 0),
         S.NodeAddress(1, 0, 0)], existing=[a])
    assert pick == S.NodeAddress(1, 0, 0)  # max topology spread


def test_transport_udt_vs_tcp_and_disk_cap(tmp_path):
    def run(S, root):
        T = S.transport
        src, dst = S.NodeAddress(0, 0, 0), S.NodeAddress(1, 0, 0)
        near = S.NodeAddress(0, 0, 1)
        udt = T.TransferSimulator(links=T.PAPER_LINKS, protocol="udt")
        tcp = T.TransferSimulator(links=T.PAPER_LINKS, protocol="tcp")
        capped = T.TransferSimulator(links=T.PAPER_LINKS, protocol="udt",
                                     disk_bw=T.PAPER_DISK_BW)
        t = udt.transfer_time(src, dst, 10 ** 9)
        return (udt.effective_bandwidth(src, dst),
                tcp.effective_bandwidth(src, dst),
                tcp.effective_bandwidth(src, near),
                udt.effective_bandwidth(src, near),
                capped.effective_bandwidth(src, dst), T.PAPER_DISK_BW,
                t, udt.bytes_moved)
    (u, t_, tn, un, cap, disk, t, moved), _ = both(tmp_path, run)
    assert u > 3 * t_
    assert tn > 0.9 * un
    assert cap == disk
    assert t > 0 and moved == 10 ** 9


def test_replica_count_convergence_after_slave_death(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root)
        c = S.SectorClient(m, "u", "pw")
        for i in range(3):
            c.upload(f"/d/f{i}.dat", bytes([i]) * 300)
        d = S.ReplicationDaemon(m)
        d.run_until_stable()
        victim = next(iter(m.lookup("/d/f0.dat").locations))
        m.slaves[victim].kill(wipe=True)
        d.run_until_stable()
        live = {i: len([s for s in m.lookup(f"/d/f{i}.dat").locations
                        if m.slaves[s].alive]) for i in range(3)}
        return live, d.run_until_stable(), index(m), m.stats
    (live, again, _, _), _ = both(tmp_path, run)
    assert all(n == 3 for n in live.values())
    assert again == 0                     # converged: nothing to do


def test_no_replication_storm_on_flapping_slave(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root, replication=2)
        c = S.SectorClient(m, "u", "pw")
        c.upload("/d/flap.dat", b"f" * 200)
        clock = [0.0]
        d = S.ReplicationDaemon(m, period=10.0, clock=lambda: clock[0])
        d.run_until_stable()
        base = m.stats["replications"]
        victim = next(iter(m.lookup("/d/flap.dat").locations))
        for _ in range(30):
            m.slaves[victim].kill(wipe=False)
            d.tick()
            m.slaves[victim].restart()
            clock[0] += 1.0
        made = m.stats["replications"] - base
        m.slaves[victim].kill(wipe=True)
        clock[0] += 10.0
        d.tick()
        live = [s for s in m.lookup("/d/flap.dat").locations
                if m.slaves[s].alive]
        return made, sorted(live), d.detector.events
    (made, live, _), _ = both(tmp_path, run)
    assert made <= 4, f"replication storm: {made} copies for 30 flaps"
    assert len(live) >= 2


def test_lost_then_recovered_bucket_roundtrip(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root)
        c = S.SectorClient(m, "u", "pw", client_addr=S.NodeAddress(0, 0, 0))
        data = b"bucket-bytes" * 50
        c.upload("/job/bucket.00001", data)
        S.ReplicationDaemon(m).run_until_stable()
        listed = set(m.lookup("/job/bucket.00001").locations)
        survivor = next(s for s in m.live_slaves()
                        if s.slave_id not in listed)
        survivor.write_file("/job/bucket.00001", data)
        for sid in listed:
            m.slaves[sid].drop_file("/job/bucket.00001")
        with pytest.raises(IOError):
            c.download("/job/bucket.00001")
        recovered = c.recover("/job/bucket.00001")
        assert all(m.slaves[s].has_file("/job/bucket.00001")
                   for s in recovered.locations)
        assert c.download("/job/bucket.00001") == data
        return survivor.slave_id, meta(recovered), m.stats
    (survivor, rec, stats), _ = both(tmp_path, run)
    assert survivor in dict(rec)["locations"]
    assert len(dict(rec)["locations"]) == 3
    assert stats["recoveries"] >= 1


@pytest.mark.parametrize("stale_on_low_id", [True, False])
def test_recover_from_scan_majority_vote_both_orders(tmp_path,
                                                     stale_on_low_id):
    def run(S, root):
        _, m = make_deployment(S, root, replication=3)
        good, stale = b"good" * 50, b"STALE" * 40
        holders = sorted(m.slaves)[:3]
        stale_holder = holders[0] if stale_on_low_id else holders[-1]
        for sid in holders:
            m.slaves[sid].write_file(
                "/d/vote.dat", stale if sid == stale_holder else good)
        m.recover_from_scan()
        assert not m.slaves[stale_holder].has_file("/d/vote.dat")
        assert S.SectorClient(m, "u", "pw").download("/d/vote.dat") == good
        return holders, stale_holder, meta(m.lookup("/d/vote.dat"))
    (holders, stale_holder, got), _ = both(tmp_path, run)
    assert dict(got)["size"] == len(b"good" * 50)
    assert set(dict(got)["locations"]) == set(holders) - {stale_holder}


def test_recover_from_scan_tie_breaks_deterministically(tmp_path):
    a, b = b"copy-a" * 30, b"copy-b" * 30

    def run(S, root):
        _, m = make_deployment(S, root, replication=2)
        s0, s1 = sorted(m.slaves)[:2]
        m.slaves[s0].write_file("/d/tie.dat", a)
        m.slaves[s1].write_file("/d/tie.dat", b)
        m.recover_from_scan()
        first = meta(m.lookup("/d/tie.dat"))
        m.recover_from_scan()
        assert meta(m.lookup("/d/tie.dat")) == first
        return first
    first, _ = both(tmp_path, run)
    assert dict(first)["md5"] == min(hashlib.md5(a).hexdigest(),
                                     hashlib.md5(b).hexdigest())


def test_failure_detector_state_machine(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root, replication=2)
        c = S.SectorClient(m, "u", "pw")
        c.upload("/d/hb.dat", b"h" * 100)
        S.ReplicationDaemon(m).run_until_stable()
        clock = [0.0]
        det = S.FailureDetector(m, suspect_after=2.0, down_after=5.0,
                                clock=lambda: clock[0])
        trail = [det.tick()]
        victim = next(iter(m.lookup("/d/hb.dat").locations))
        m.slaves[victim].kill(wipe=False)
        for t in (1.0, 3.0, 6.0, 7.0):
            clock[0] = t
            trail.append((det.tick(), det.state[victim],
                          det.believes_alive(victim),
                          meta(m.lookup("/d/hb.dat"))))
        m.slaves[victim].restart()
        clock[0] = 8.0
        trail.append((det.tick(), det.state[victim],
                      meta(m.lookup("/d/hb.dat"))))
        return victim, trail, det.stats, det.events
    (victim, trail, stats, events), _ = both(tmp_path, run)
    assert trail[0] == []
    assert trail[1][:3] == ([], "alive", True)
    assert trail[2][:3] == ([], "suspect", True)   # suspicion is not death
    assert trail[3][:3] == ([victim], "down", False)
    assert victim not in dict(trail[3][3])["locations"]     # pruned
    assert trail[4][0] == []                       # down is declared ONCE
    assert trail[5][:2] == ([], "alive")
    assert victim in dict(trail[5][2])["locations"]  # scan re-absorbed
    assert stats == {"suspected": 1, "downed": 1, "rejoined": 1}
    assert any("rejoined" in e for e in events)


def test_detector_driven_daemon_waits_for_down(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root, replication=2)
        c = S.SectorClient(m, "u", "pw")
        c.upload("/d/bel.dat", b"b" * 100)
        clock = [0.0]
        det = S.FailureDetector(m, suspect_after=1.0, down_after=3.0,
                                clock=lambda: clock[0])
        d = S.ReplicationDaemon(m, clock=lambda: clock[0], detector=det)
        d.run_until_stable()
        base = m.stats["replications"]
        victim = next(iter(m.lookup("/d/bel.dat").locations))
        m.slaves[victim].kill(wipe=True)
        clock[0] = 2.0
        d.tick()
        mid = (det.state[victim], m.stats["replications"] - base)
        clock[0] = 4.0
        d.tick()
        live = [s for s in m.lookup("/d/bel.dat").locations
                if m.slaves[s].alive]
        return mid, det.state[victim], m.stats["replications"] - base, \
            sorted(live)
    (mid, state, made, live), _ = both(tmp_path, run)
    assert mid == ("suspect", 0)          # believed alive: no healing
    assert state == "down" and made > 0
    assert len(live) >= 2


def test_recover_raises_when_all_copies_gone(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root)
        c = S.SectorClient(m, "u", "pw")
        c.upload("/d/gone.dat", b"g" * 100)
        S.ReplicationDaemon(m).run_until_stable()
        for s in m.slaves.values():
            s.drop_file("/d/gone.dat")
        with pytest.raises(IOError, match="no surviving replica") as e:
            c.recover("/d/gone.dat")
        lost = m.stats["lost_files"]
        c.upload("/d/fine.dat", b"ok" * 50)
        before = m.stats["recoveries"]
        c.recover("/d/fine.dat")
        assert c.download("/d/fine.dat") == b"ok" * 50
        return str(e.value), lost, m.stats["recoveries"] - before
    (_, lost, _), _ = both(tmp_path, run)
    assert lost >= 1


# -- tests/test_retry.py: the policy and SectorClient.recover -----------------


def test_retry_policy_schedules_match():
    for kw in ({"base": 0.1, "factor": 2.0, "cap": 1.0}, {},
               {"base": 0.5, "factor": 2.0, "cap": 60.0, "jitter": 0.2,
                "seed": 7}):
        ref, port = j_retry.RetryPolicy(**kw), t_retry.RetryPolicy(**kw)
        for key in range(4):
            assert port.schedule(8, key=key) == ref.schedule(8, key=key)
    p = t_retry.RetryPolicy(base=0.1, factor=2.0, cap=1.0)
    assert p.delay(5) == 1.0 and p.delay(50) == 1.0
    with pytest.raises(ValueError):
        p.delay(-1)
    for bad in ({"base": -1.0}, {"factor": 0.5}, {"jitter": 1.0},
                {"cap": -0.1}):
        with pytest.raises(ValueError):
            t_retry.RetryPolicy(**bad)


def test_client_recover_retries_until_survivor_appears(tmp_path):
    def run(S, root):
        _, m = make_deployment(S, root, replication=2)
        data = b"flaky" * 40
        slept = []

        def sleep(d):
            slept.append(d)
            if len(slept) == 2:        # the survivor comes back mid-backoff
                stash.write_file("/d/flaky.dat", data)

        c = S.SectorClient(m, "u", "pw",
                           retry_policy=S.RetryPolicy(base=0.0),
                           recover_attempts=4, sleep=sleep)
        c.upload("/d/flaky.dat", data)
        stash = next(s for s in m.live_slaves()
                     if s.slave_id not in m.lookup("/d/flaky.dat").locations)
        for s in m.slaves.values():
            s.drop_file("/d/flaky.dat")
        got = meta(c.recover("/d/flaky.dat"))
        first = list(slept)
        assert c.download("/d/flaky.dat") == data
        for s in m.slaves.values():
            s.drop_file("/d/flaky.dat")
        slept.clear()
        with pytest.raises(IOError):
            S.SectorClient(m, "u", "pw", retry_policy=S.RetryPolicy(),
                           recover_attempts=3, sleep=slept.append
                           ).recover("/d/flaky.dat")
        return stash.slave_id, got, first, list(slept)
    (stash, got, first, second), _ = both(tmp_path, run)
    assert len(first) == 2                         # failed twice, then won
    assert stash in dict(got)["locations"]
    assert len(second) == 2                        # attempts-1 backoffs
