"""The port's host data plane — ``SphereProcess`` / SPEs over Sector and
``HostExecutor`` — against the JAX package's, on the CPU.

Each case builds one Sector deployment per package under ``tmp_path``
(``make_sector``), uploads byte-identical inputs, and runs the same
pipeline: numpy/``jax.numpy`` UDFs on the reference, torch UDFs on the
port (``device="cpu"``, where K1 and K2 take their plain versions). The
output records must be equal exactly, every bucket file the run wrote to
Sector byte-identical (found by listing the scratch prefix), and the
fault accounting (errors, retries, recoveries, data errors) equal. The
cases mirror the ``SphereProcess`` cases of ``tests/test_system.py``, the
engine case of ``tests/test_retry.py`` and the host cases of
``tests/test_dataflow.py``, and add the faults, key dtypes and empty
buckets the port's device path handles on its own.
"""

import collections
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.mapreduce as j_mr
import repro.core.records as j_records
import repro.launch.train as j_train
import repro.obs.metrics as j_metrics
import repro.obs.trace as j_trace
import repro.sphere.dataflow as j_dataflow
import repro.sphere.engine as j_engine
import repro.sphere.spe as j_spe
import repro_torch.core.mapreduce as t_mr
import repro_torch.core.records as t_records
import repro_torch.core.retry as t_retry
import repro_torch.launch.train as t_train
import repro_torch.obs.metrics as t_metrics
import repro_torch.obs.trace as t_trace
import repro_torch.sphere.dataflow as t_dataflow
import repro_torch.sphere.engine as t_engine
import repro_torch.sphere.spe as t_spe
from repro.core.retry import RetryPolicy as JRetryPolicy
from repro_torch.comm import Ranks
from repro_torch.kernels import partition, radix_sort

NB = 8
INT32_MIN, INT32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def _side(train, dataflow, engine, spe, records, mr, metrics, trace, retry,
          kw):
    return types.SimpleNamespace(
        make_sector=train.make_sector, Dataflow=dataflow.Dataflow,
        HostExecutor=dataflow.HostExecutor, SphereProcess=engine.SphereProcess,
        SPE=spe.SPE, RecordCodec=records.RecordCodec, mr=mr,
        REGISTRY=metrics.REGISTRY, MS_BUCKETS=metrics.MS_BUCKETS,
        Tracer=trace.Tracer, RetryPolicy=retry, kw=kw)


JAX = _side(j_train, j_dataflow, j_engine, j_spe, j_records, j_mr, j_metrics,
            j_trace, JRetryPolicy, {})
PORT = _side(t_train, t_dataflow, t_engine, t_spe, t_records, t_mr,
             t_metrics, t_trace, t_retry.RetryPolicy, {"device": "cpu"})


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def deploy(side, root, slices, num_slaves=4, replication=2,
           prefix="/in/x"):
    master, client, daemon = side.make_sector(str(root), num_slaves,
                                              replication)
    client.upload_dataset(prefix, [np.ascontiguousarray(s).tobytes()
                                   for s in slices])
    daemon.run_until_stable()
    paths = [f"{prefix}.{i:05d}" for i in range(len(slices))]
    return master, client, daemon, paths


def bucket_files(client, prefix="/.dataflow"):
    """Every file the run wrote under the scratch prefix, keyed by its path
    below the run's own directory (run numbers differ by package)."""
    return {m.path.split("/", 3)[3]: client.download(m.path)
            for m in client.ls(prefix)}


def host_run(side, root, pipeline, slices, n_spes=4, num_slaves=4,
             fail_after=None, daemon_attached=False, before=None,
             between=None, trace=None):
    """Deploy, optionally inject a fault ``before`` the run or ``between``
    phases (after the bucket files are replicated), run ``pipeline`` with
    ``HostExecutor`` and return everything observable."""
    master, client, daemon, paths = deploy(side, root, slices,
                                           num_slaves=num_slaves)
    spes = [side.SPE(i, master.slaves[i % num_slaves].address, master,
                     client.session_id,
                     fail_after=(fail_after or {}).get(i))
            for i in range(n_spes)]
    if before is not None:
        before(master, paths, spes)
    d = daemon if daemon_attached else None
    if between is not None:
        d = _FaultAfterReplication(daemon, lambda: between(master))
    ex = side.HostExecutor(master, client, spes, daemon=d, **side.kw)
    res = ex.run(pipeline, paths, trace=trace)
    recs = {k: _np(v) for k, v in res.records.items()}
    assert _np(res.valid).all() and _np(res.valid).shape[0] == len(
        next(iter(recs.values())))
    return {"records": recs, "files": bucket_files(client),
            "errors": res.errors, "retries": res.retries,
            "recoveries": res.recoveries, "data_errors": res.data_errors,
            "dropped": int(res.dropped),
            "segments": [p["segments"] for p in res.phase_times],
            "stats": dict(master.stats)}


class _FaultAfterReplication:
    """Stands in for the executor's daemon: replicates, then fires
    ``fault`` once — a fault at the boundary before the next phase."""

    def __init__(self, daemon, fault):
        self.daemon, self.fault, self.fired = daemon, fault, False

    def run_until_stable(self):
        made = self.daemon.run_until_stable()
        if not self.fired:
            self.fired = True
            self.fault()
        return made


def assert_same(ref, port):
    assert sorted(port["records"]) == sorted(ref["records"])
    for k, want in ref["records"].items():
        got = port["records"][k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k
    assert sorted(port["files"]) == sorted(ref["files"])
    for path, data in ref["files"].items():
        assert port["files"][path] == data, path
    for k in ("errors", "retries", "recoveries", "data_errors", "dropped",
              "segments", "stats"):
        assert port[k] == ref[k], k


def both(tmp_path, pipelines, slices, **kw):
    ref = host_run(JAX, tmp_path / "jax", pipelines[0], slices, **kw)
    port = host_run(PORT, tmp_path / "torch", pipelines[1], slices, **kw)
    assert_same(ref, port)
    return port


# -- pipelines, once per package -----------------------------------------------


def sort_pipelines(fields, **sort_kw):
    return tuple(side.Dataflow.source(side.RecordCodec.from_fields(fields))
                 .sort(key=lambda r: r["key"], **sort_kw)
                 for side in (JAX, PORT))


def _j_emit(rec):
    return {"key": rec["word"].astype(jnp.int32),
            "value": jnp.ones_like(rec["word"], jnp.int32)}


def _j_count(rec, valid):
    k, v, dropped = j_mr.reduce_by_key_sum(rec["key"], rec["value"], valid)
    return {"key": k, "value": v}, k >= 0, dropped


def _t_emit(rec):
    return {"key": rec["word"].to(torch.int32),
            "value": torch.ones_like(rec["word"], dtype=torch.int32)}


def _t_count(rec, valid):
    k, v, dropped = t_mr.reduce_by_key_sum(rec["key"], rec["value"], valid)
    return {"key": k, "value": v}, k >= 0, dropped


def index_pipelines():
    word_page = {"word": np.uint8, "page": np.uint8}
    j = (JAX.Dataflow.source(JAX.RecordCodec.from_fields(word_page))
         .map(_j_emit)
         .shuffle(by=lambda r: j_mr.default_hash(r["key"], NB),
                  num_buckets=NB)
         .reduce(_j_count))
    t = (PORT.Dataflow.source(PORT.RecordCodec.from_fields(word_page))
         .map(_t_emit)
         .shuffle(by=lambda r: t_mr.default_hash(r["key"], NB),
                  num_buckets=NB)
         .reduce(_t_count))
    return j, t


def pages(seed=7, n=4, per=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(0, 26, size=(per, 2), dtype=np.uint8)
        p[:, 1] = i
        out.append(p)
    return out


def sort_slices(keys, value, fields, n=4):
    codec = j_records.RecordCodec.from_fields(fields)
    return np.array_split(codec.encode({"key": keys, "value": value}), n)


FIELDS = {"key": np.int32, "value": (np.uint8, (12,))}


def random_sort_input(n=4 * 300, seed=3):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, INT32_MAX, size=n).astype(np.int32)
    value = rng.integers(0, 256, size=(n, 12), dtype=np.uint8)
    return keys, value


def check_sorted(port, keys, value):
    k, v = port["records"]["key"], port["records"]["value"]
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k, keys[order])
    np.testing.assert_array_equal(v, value[order])


# -- HostExecutor: Terasort over Sector files ----------------------------------


def test_host_sort_default_splitters_matches_jax(tmp_path):
    keys, value = random_sort_input()
    port = both(tmp_path, sort_pipelines(FIELDS, num_buckets=NB),
                sort_slices(keys, value, FIELDS))
    check_sorted(port, keys, value)
    assert len(port["files"]) == NB and port["segments"] == [4, NB]


def test_host_sort_explicit_splitters_matches_jax(tmp_path):
    keys, value = random_sort_input(seed=4)
    spl = np.sort(np.random.default_rng(5).integers(
        0, INT32_MAX, size=NB - 1)).astype(np.int32)
    port = both(tmp_path, sort_pipelines(FIELDS, splitters=spl),
                sort_slices(keys, value, FIELDS))
    check_sorted(port, keys, value)
    assert len(port["files"]) == NB


def test_host_sort_duplicate_keys_and_int32_extremes(tmp_path):
    rng = np.random.default_rng(11)
    n = 4 * 250
    keys = rng.choice(np.array([INT32_MIN, -7, 0, 3, 3, 1 << 30,
                                INT32_MAX - 1, INT32_MAX], np.int32), n)
    value = rng.integers(0, 256, size=(n, 12), dtype=np.uint8)
    value[:, :4] = np.arange(n, dtype=np.int32).view(np.uint8).reshape(n, 4)
    port = both(tmp_path, sort_pipelines(FIELDS, num_buckets=NB),
                sort_slices(keys, value, FIELDS))
    check_sorted(port, keys, value)        # stable: ties keep input order


def test_host_sort_float_keys_signed_zero_and_nan(tmp_path):
    """``np.argsort(kind="stable")`` keeps -0.0 and +0.0 in input order and
    puts every NaN last; the port canonicalises float keys before K2 so
    that its order is the same. Stage 1 casts the keys to int32 as numpy
    does (NaN and +-inf to INT32_MIN)."""
    rng = np.random.default_rng(12)
    n = 4 * 200
    pool = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5, -1.5,
                     7.25, -7.25, 1e9, -1e9, 3e9, 2.5], np.float32)
    keys = rng.choice(pool, n).astype(np.float32)
    bits = keys.view(np.uint32)
    bits[rng.random(n) < 0.1] = 0xFFC00001      # negative NaNs, own payload
    value = np.arange(n, dtype=np.int32).view(np.uint8).reshape(n, 4)
    value = np.concatenate([value, rng.integers(0, 256, (n, 8), np.uint8)],
                           axis=1)
    fields = {"key": np.float32, "value": (np.uint8, (12,))}
    spl = np.array([-5, 0, 5], np.int32)
    port = both(tmp_path, sort_pipelines(fields, splitters=spl),
                sort_slices(keys, value, fields))
    k = port["records"]["key"]
    zeros = np.signbit(k[k == 0])
    assert zeros.any() and not zeros.all()
    assert np.isnan(k).sum() == np.isnan(keys).sum() > 0


def test_host_sort_empty_bucket_and_empty_output(tmp_path):
    keys, value = random_sort_input(n=4 * 64, seed=6)
    keys = np.where(keys % 2 == 0, 5, 900).astype(np.int32)
    spl = np.array([100, 200, 300], np.int32)   # buckets 1 and 2 stay empty
    port = both(tmp_path, sort_pipelines(FIELDS, splitters=spl),
                sort_slices(keys, value, FIELDS))
    assert port["files"]["s0.00001"] == b"" == port["files"]["s0.00002"]
    assert port["segments"] == [4, 2]
    check_sorted(port, keys, value)

    def drop_all(side):                         # every id out of range
        codec = side.RecordCodec.from_fields(FIELDS)
        return side.Dataflow.source(codec).shuffle(
            by=lambda r: r["key"] * 0 - 1, num_buckets=4)
    port = both(tmp_path / "none", (drop_all(JAX), drop_all(PORT)),
                sort_slices(keys, value, FIELDS))
    assert port["records"]["key"].shape == (0,)
    assert port["records"]["value"].shape == (0, 12)
    assert all(v == b"" for v in port["files"].values())


def test_host_sort_spe_crash_matches_jax(tmp_path):
    keys, value = random_sort_input(seed=8)
    port = both(tmp_path, sort_pipelines(FIELDS, num_buckets=NB),
                sort_slices(keys, value, FIELDS), fail_after={0: 1})
    assert port["retries"] > 0 and not port["errors"]
    check_sorted(port, keys, value)


def test_host_sort_killed_slave_and_lost_bucket_recover(tmp_path):
    """After phase 0's bucket files are replicated, one slave dies with its
    disk and every listed copy of one bucket file vanishes while an
    unlisted copy survives: phase 1 reroutes around the dead slave and
    ``SectorClient.recover`` restores the bucket (the chaos suite's
    ``kill_slave`` and ``drop_bucket`` at boundary 1)."""
    keys, value = random_sort_input(seed=9)

    def fault(master):
        master.slaves[1].kill(wipe=True)
        path = sorted(p for p in master.index if p.endswith("s0.00003"))[0]
        meta = master.lookup(path)
        data = next(master.slaves[s].read_file(path)
                    for s in sorted(meta.locations)
                    if master.slaves[s].has_file(path))
        stash = min((s for s in master.live_slaves()
                     if s.slave_id not in meta.locations),
                    key=lambda s: s.slave_id)
        stash.write_file(path, data)
        for sid in meta.locations:
            master.slaves[sid].drop_file(path)

    port = both(tmp_path, sort_pipelines(FIELDS, num_buckets=NB),
                sort_slices(keys, value, FIELDS), num_slaves=6,
                between=fault)
    assert port["recoveries"] >= 1 and port["stats"]["recoveries"] >= 1
    assert not port["errors"] and port["data_errors"] == 0
    check_sorted(port, keys, value)


def test_host_lost_input_is_a_counted_data_error(tmp_path):
    keys, value = random_sort_input(seed=10)

    def lose(master, paths, spes):
        for slave in master.slaves.values():
            slave.drop_file(paths[0])
    port = both(tmp_path, sort_pipelines(FIELDS, num_buckets=NB),
                sort_slices(keys, value, FIELDS), daemon_attached=True,
                before=lose)
    assert port["data_errors"] == 1
    assert list(port["errors"]) == [(0, 0)]
    assert port["records"]["key"].shape[0] == 3 * 300


def test_host_int64_keys_take_the_library_sort(tmp_path, monkeypatch):
    rng = np.random.default_rng(13)
    n = 4 * 100
    keys = rng.integers(-(1 << 40), 1 << 40, size=n)
    keys[::7] = keys[3]
    value = rng.integers(0, 256, size=(n, 12), dtype=np.uint8)
    fields = {"key": np.int64, "value": (np.uint8, (12,))}
    k2_calls = []
    monkeypatch.setattr(radix_sort, "sort_kv_segments_radix",
                        lambda *a: k2_calls.append(1))
    lib = t_metrics.REGISTRY.counter("host.sort_library")
    before = lib.value
    port = both(tmp_path, sort_pipelines(fields, num_buckets=4),
                sort_slices(keys, value, fields))
    assert lib.value - before == port["segments"][1] > 0
    assert k2_calls == []
    # buckets split by the int32 cast of the keys (as in the reference),
    # so only each bucket is sorted by the int64 key
    np.testing.assert_array_equal(np.sort(port["records"]["key"]),
                                  np.sort(keys))


def test_host_path_runs_k1_per_segment_and_k2_per_bucket(tmp_path,
                                                         monkeypatch):
    """Which kernel each step calls: the bucket split K1 once per phase-0
    segment with ``nb`` destinations, the stage-2 sort K2 once per
    non-empty phase-1 bucket file."""
    calls = {"k1": [], "k2": []}
    k1, k2 = partition.partition_rank, radix_sort.sort_kv_segments_radix

    def spy1(dest, num_dest):
        calls["k1"].append((tuple(dest.shape), num_dest))
        return k1(dest, num_dest)

    def spy2(keys, values):
        calls["k2"].append(tuple(keys.shape))
        return k2(keys, values)
    monkeypatch.setattr(partition, "partition_rank", spy1)
    monkeypatch.setattr(radix_sort, "sort_kv_segments_radix", spy2)
    keys, value = random_sort_input(seed=14)
    res = host_run(PORT, tmp_path, sort_pipelines(FIELDS, num_buckets=NB)[1],
                   sort_slices(keys, value, FIELDS))
    assert calls["k1"] == [((300,), NB)] * 4
    sizes = [len(v) // 16 for _, v in sorted(res["files"].items())]
    assert calls["k2"] == [(1, s) for s in sizes if s]
    check_sorted(res, keys, value)


def test_host_sort_matches_the_ports_spmd_sort(tmp_path):
    keys, value = random_sort_input(n=8 * 128, seed=15)
    host = host_run(PORT, tmp_path, sort_pipelines(FIELDS, num_buckets=NB)[1],
                    sort_slices(keys, value, FIELDS))
    rk = Ranks(8, device="cpu")
    df = t_dataflow.Dataflow.source().sort(key=lambda r: r["key"],
                                           num_buckets=NB)
    spmd = t_dataflow.SPMDExecutor(rk, sort_algo="radix").run(
        df, {"key": torch.from_numpy(keys).reshape(8, -1),
             "value": torch.from_numpy(value).reshape(8, -1, 12)})
    valid = spmd.valid.reshape(-1)
    assert int(spmd.dropped) == 0
    np.testing.assert_array_equal(
        spmd.records["key"].reshape(-1)[valid].numpy(),
        host["records"]["key"])


def test_host_envelopes_raise_before_any_work(tmp_path, monkeypatch):
    keys, value = random_sort_input(n=4 * 16)
    master, client, _, paths = deploy(PORT, tmp_path,
                                      sort_slices(keys, value, FIELDS))
    spes = [PORT.SPE(i, master.slaves[i].address, master, client.session_id)
            for i in range(4)]
    ex = PORT.HostExecutor(master, client, spes, device="cpu")
    wide = sort_pipelines(FIELDS, num_buckets=partition.MAX_NUM_DEST + 1)[1]
    with pytest.raises(ValueError, match="envelope"):
        ex.run(wide, paths)
    assert client.ls("/.dataflow") == []
    monkeypatch.setattr(radix_sort, "MAX_SEGMENT_LEN", 8)
    with pytest.raises(ValueError, match="exceeds"):
        t_dataflow.stable_argsort(torch.arange(9, dtype=torch.int32))
    with pytest.raises(TypeError):
        ex.run(sort_pipelines(FIELDS, num_buckets=NB)[1], paths, chaos=1)


@pytest.mark.parametrize("fault", ["k2_envelope", "k1_launch"])
def test_host_kernel_faults_raise_out_of_run(tmp_path, monkeypatch, fault):
    """A failure of the executor's own kernel steps is raised out of
    ``run``, with its reason: not retried into a data error of the user's
    UDF, and no partial result."""
    if fault == "k2_envelope":
        monkeypatch.setattr(radix_sort, "MAX_SEGMENT_LEN", 8)
        match = "stable_argsort: .*exceeds"
    else:
        def broken(dest, num_dest):
            raise RuntimeError("launch failed")
        monkeypatch.setattr(partition, "partition_rank", broken)
        match = "_bucket_major: launch failed"
    keys, value = random_sort_input(n=4 * 64, seed=16)
    master, client, _, paths = deploy(PORT, tmp_path,
                                      sort_slices(keys, value, FIELDS))
    spes = [PORT.SPE(i, master.slaves[i].address, master, client.session_id)
            for i in range(4)]
    ex = PORT.HostExecutor(master, client, spes, device="cpu")
    errors = t_metrics.REGISTRY.counter("host.data_errors")
    before = errors.value
    with pytest.raises(t_dataflow.ExecutorFault, match=match):
        ex.run(sort_pipelines(FIELDS, num_buckets=NB)[1], paths)
    # the engine's own accounting of the failed phase is left as it is
    assert errors.value > before


def test_host_executor_runs_on_the_card_by_default(tmp_path, monkeypatch):
    master, client, _, _ = deploy(PORT, tmp_path, [np.zeros((4, 16),
                                                            np.uint8)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        PORT.HostExecutor(master, client, [])
    with pytest.raises(RuntimeError, match="is_available"):
        PORT.SphereProcess(master, client.session_id, [])


# -- HostExecutor: the inverted index (map -> shuffle -> reduce) ----------------


def _counts(port):
    rec = port["records"]
    return {int(k): int(v) for k, v in zip(rec["key"], rec["value"])}


def test_host_inverted_index_matches_jax(tmp_path):
    ps = pages()
    port = both(tmp_path, index_pipelines(), ps)
    allpages = np.concatenate(ps)
    assert _counts(port) == dict(collections.Counter(allpages[:, 0].tolist()))
    assert port["dropped"] == 0 and port["segments"] == [4, NB]


def test_host_inverted_index_spe_crash_matches_jax(tmp_path):
    """``tests/test_dataflow.py``'s host half: SPE 0 crashes on its first
    segment and the retry absorbs it."""
    ps = pages()
    port = both(tmp_path, index_pipelines(), ps, fail_after={0: 0})
    assert port["retries"] >= 1 and not port["errors"]
    allpages = np.concatenate(ps)
    assert _counts(port) == dict(collections.Counter(allpages[:, 0].tolist()))


def test_host_inverted_index_kill_slave_with_daemon(tmp_path):
    """The chaos suite's ``kill_slave`` at boundary 0 with the SPE on the
    victim crashing: master rerouting, re-pooling and the daemon's
    re-replication of the bucket files."""
    ps = pages(n=4, per=40)

    def kill(master, paths, spes):
        # the SPE on the victim ties on distance and wins on id, so it gets
        # work first and crashes; the other one sits far away
        far = type(spes[0].address)(9, 9, 9)
        spes[1:] = [type(spes[0])(1, far, master, spes[0].session_id)]
        master.slaves[0].kill(wipe=True)
        spes[0].fail_after = spes[0].segments_done
    port = both(tmp_path, index_pipelines(), ps, num_slaves=4, n_spes=2,
                daemon_attached=True, before=kill)
    assert port["retries"] >= 1 and not port["errors"]
    allpages = np.concatenate(ps)
    assert _counts(port) == dict(collections.Counter(allpages[:, 0].tolist()))


def test_host_trace_spans_match_jax(tmp_path):
    ps = pages()
    names = []
    for side, df, sub in ((JAX, index_pipelines()[0], "jax"),
                          (PORT, index_pipelines()[1], "torch")):
        tr = side.Tracer()
        host_run(side, tmp_path / sub, df, ps, trace=tr)
        names.append(sorted({s.name for s in tr.buffer.spans()}))
    assert names[1] == names[0]
    assert {"host.run", "phase[0]", "phase[1]", "hop[0]:buckets",
            "spe.read", "spe.udf"} <= set(names[1])


# -- SphereProcess (tests/test_system.py, test_retry.py, test_dataflow.py) -----


def _engine_deploy(side, root, slices, prefix, num_slaves=6):
    master, client, daemon, paths = deploy(side, root, slices,
                                           num_slaves=num_slaves,
                                           prefix=prefix)
    return master, client, paths


def test_sphere_process_find_brown_dwarfs(tmp_path):
    rng = np.random.default_rng(0)
    slices = [rng.integers(0, 256, size=(50, 64), dtype=np.uint8)
              for _ in range(4)]
    out = []
    for side, sub in ((JAX, "jax"), (PORT, "torch")):
        master, client, paths = _engine_deploy(side, tmp_path / sub, slices,
                                               "/sdss/slice")
        spes = [side.SPE(i, master.slaves[i].address, master,
                         client.session_id, fail_after=0 if i == 0 else None)
                for i in range(4)]
        proc = side.SphereProcess(master, client.session_id, spes,
                                  **side.kw)
        res = proc.run(paths, lambda r: r[:, 0][r[:, 0] > 200], 64)
        out.append((_np(res.concat()), res.errors, res.retries,
                    sorted(res.outputs)))
    (ref, rerr, rret, rseg), (got, gerr, gret, gseg) = out
    np.testing.assert_array_equal(got, ref)
    assert (gerr, gret, gseg) == (rerr, rret, rseg)
    assert not gerr and gret >= 1
    want = np.sort(np.concatenate([s[:, 0][s[:, 0] > 200] for s in slices]))
    np.testing.assert_array_equal(np.sort(got), want)


def test_sphere_bucket_output_inverted_index(tmp_path):
    rng = np.random.default_rng(1)
    ps = [rng.integers(0, 26, size=(40, 2), dtype=np.uint8)
          for _ in range(3)]
    for i, p in enumerate(ps):
        p[:, 1] = i
    nb = 4
    out = []
    for side, sub in ((JAX, "jax"), (PORT, "torch")):
        master, client, paths = _engine_deploy(side, tmp_path / sub, ps,
                                               "/web/page")
        spes = [side.SPE(i, master.slaves[i].address, master,
                         client.session_id) for i in range(3)]
        proc = side.SphereProcess(master, client.session_id, spes,
                                  **side.kw)
        res = proc.run(paths, lambda r: r.reshape(-1, 2), record_bytes=2,
                       bucket_fn=lambda o: {b: o[o[:, 0] % nb == b]
                                            for b in range(nb)},
                       num_buckets=nb)
        out.append({b: v for b, v in res.outputs.items()})
    for b in range(nb):
        assert isinstance(out[1][b], np.ndarray)
        assert out[1][b].tobytes() == out[0][b].tobytes()
        assert out[1][b].shape == out[0][b].shape


def test_engine_empty_bucket_keeps_dtype_and_shape(tmp_path):
    rec = np.arange(24, dtype=np.uint8).reshape(12, 2)
    master, client, paths = _engine_deploy(PORT, tmp_path, [rec], "/data/x",
                                           num_slaves=3)
    spes = [PORT.SPE(i, master.slaves[i].address, master, client.session_id)
            for i in range(3)]
    proc = PORT.SphereProcess(master, client.session_id, spes, device="cpu")
    res = proc.run(paths, lambda r: r.reshape(-1, 2), record_bytes=2,
                   bucket_fn=lambda out: {0: out}, num_buckets=4)
    assert res.outputs[0].shape == (12, 2)
    for b in (1, 2, 3):
        assert res.outputs[b].shape == (0, 2)
        assert res.outputs[b].dtype == np.uint8


def test_engine_retry_events_carry_attempt_and_delay(tmp_path):
    rng = np.random.default_rng(0)
    slices = [rng.integers(0, 256, size=(32, 4), dtype=np.uint8)
              for _ in range(2)]
    out = []
    for side, sub in ((JAX, "jax"), (PORT, "torch")):
        master, client, paths = _engine_deploy(side, tmp_path / sub, slices,
                                               "/r/rec")
        spes = [side.SPE(i, master.slaves[i].address, master,
                         client.session_id) for i in range(2)]
        hist = side.REGISTRY.histogram("host.backoff_ms",
                                       bounds=side.MS_BUCKETS)
        before = hist.snapshot()["count"]
        calls = {"n": 0}

        def flaky_udf(records):
            calls["n"] += 1
            if calls["n"] <= 2:                    # first try per segment dies
                raise ValueError("transient")
            return records

        sleeps = []
        proc = side.SphereProcess(
            master, client.session_id, spes, max_retries=3,
            retry_policy=side.RetryPolicy(base=0.01, jitter=0.5, seed=2),
            sleep=sleeps.append, **side.kw)
        tr = side.Tracer()
        res = proc.run(paths, flaky_udf, record_bytes=4, trace=tr)
        events = [dict(e.attrs) for e in tr.buffer.events()
                  if e.name == "retry"]
        out.append((res.errors, res.retries, events, sleeps,
                    hist.snapshot()["count"] - before,
                    [_np(res.outputs[i]).tobytes() for i in sorted(
                        res.outputs)]))
    assert out[1] == out[0]
    errors, retries, events, sleeps, observed, _ = out[1]
    assert not errors and retries >= 2 and len(events) >= 2
    assert all(e["attempt"] >= 1 and e["delay_ms"] > 0.0
               and e["reason"] == "udf_error" for e in events)
    assert [round(s * 1e3, 3) for s in sleeps] == [e["delay_ms"]
                                                   for e in events]
    assert observed == len(events)
