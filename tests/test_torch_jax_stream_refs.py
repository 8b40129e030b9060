"""The JAX references of the port's chaos and streaming tests, from ONE
subprocess.

``tests/test_torch_chaos.py`` and ``tests/test_torch_streaming.py`` hold
the port on ``Ranks(8, device="cpu")`` and the ``(dc, node) = (2, 4)``
grid against the JAX package on 8 virtual CPU devices (Auto-axis meshes
from ``repro.compat.make_mesh``): the SPMD chaos matrix, the two-hop and
sort resumes, stream against batch, a mid-stream lost device, streamed
sort batches, per-stage traces and the stream-chaos soak of
``benchmarks/stream_chaos_bench.py``. One subprocess computes every one of
these references, writes them to ``out.json`` / ``out.npz`` and
:func:`stream_references` returns them, once per session (shared by the
xdist workers through :func:`test_torch_jax_refs.session_shared`).

The inputs are this module's functions, so both packages draw the same
numpy data. This module holds no tests of its own.
"""

import json
import os

import numpy as np

from test_torch_jax_refs import run_jax_8dev, session_shared

BENCH = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "benchmarks"))
NB = 8
SEEDS = (0, 1, 2)
MB = 8 * 32             # stream micro-batch of the stream tests
K = 7                   # micro-batches of stream == batch


def matrix_words():
    """The words of ``tests/test_chaos.py``'s SPMD matrix."""
    return np.random.default_rng(7).integers(0, 26, size=8 * 64).astype(
        np.uint8)


def two_hop_words():
    return np.random.default_rng(13).integers(0, 26, size=8 * 64).astype(
        np.uint8)


def sort_inputs():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**31 - 2, size=8 * 128).astype(np.int32)
    return keys, np.arange(8 * 128, dtype=np.int32)


def stream_words():
    """stream == batch: K micro-batches of MB words."""
    return np.random.default_rng(13).integers(0, 26, size=K * MB,
                                              dtype=np.uint8)


def device_loss_words():
    return np.random.default_rng(21).integers(0, 26, size=5 * MB,
                                              dtype=np.uint8)


def sort_batches():
    """Five micro-batches of 8 x 64 int32 keys for the streamed sort."""
    rng = np.random.default_rng(4)
    return [rng.integers(0, 2**31 - 2, size=8 * 64).astype(np.int32)
            for _ in range(5)]


_CODE = """
import collections, json, sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {bench!r})
sys.path.insert(0, {tests!r})
from repro.compat import make_mesh
from repro.core.mapreduce import default_hash, reduce_by_key_sum
from repro.obs.trace import Tracer
from repro.sphere.chaos import ChaosSchedule, FaultPlan
from repro.sphere.dataflow import Dataflow, SPMDExecutor
from repro.sphere.streaming import StreamExecutor, TenantQueue
import test_torch_jax_stream_refs as R
import stream_chaos_bench

NB = R.NB
out, arr = {{}}, {{}}
def emit(rec):
    return {{"key": rec["word"].astype(jnp.int32),
             "value": jnp.ones_like(rec["word"], jnp.int32)}}
def count(rec, valid):
    k, v, dropped = reduce_by_key_sum(rec["key"], rec["value"], valid)
    return {{"key": k, "value": v}}, k >= 0, dropped
def counts(rec):
    return sorted([int(k), int(v)] for k, v in zip(rec["key"], rec["value"]))
def run_info(res, plan):
    return {{"counts": counts(res.valid_records()),
             "dropped": int(res.dropped), "recoveries": res.recoveries,
             "events": list(plan.events) if plan is not None else []}}

flat = (make_mesh((8,), ("data",)), ("data",))
grid = (make_mesh((2, 4), ("dc", "node")), ("dc", "node"))

# -- the SPMD chaos matrix: flat and grid x boundaries x seeds
df = (Dataflow.source().map(emit)
      .shuffle(by=lambda r: default_hash(r["key"], NB), num_buckets=NB)
      .reduce(count))
src = {{"word": jnp.asarray(R.matrix_words())}}
for tag, (mesh, axes) in (("flat", flat), ("grid", grid)):
    ex = SPMDExecutor(mesh, axes=axes)
    with mesh:
        out[f"matrix_{{tag}}_clean"] = run_info(ex.run(df, src), None)
        plan = FaultPlan(kind="none")
        out[f"matrix_{{tag}}_none"] = run_info(ex.run(df, src, chaos=plan),
                                              plan)
        for phase in (0, 1):
            for seed in R.SEEDS:
                plan = FaultPlan(kind="lose_device", phase=phase, seed=seed)
                out[f"matrix_{{tag}}_{{phase}}_{{seed}}"] = run_info(
                    ex.run(df, src, chaos=plan), plan)

# -- two shuffle hops, a device lost at every boundary
df2 = (Dataflow.source().map(emit)
       .shuffle(by=lambda r: default_hash(r["key"] * 7 + 13, NB),
                num_buckets=NB, capacity_factor=6.0)
       .shuffle(by=lambda r: r["key"] % NB, num_buckets=NB,
                capacity_factor=6.0)
       .reduce(count))
src2 = {{"word": jnp.asarray(R.two_hop_words())}}
mesh, axes = flat
ex = SPMDExecutor(mesh)
with mesh:
    out["two_hop_clean"] = run_info(ex.run(df2, src2), None)
    for phase in (0, 1, 2):
        for seed in (0, 1):
            plan = FaultPlan(kind="lose_device", phase=phase, seed=seed)
            out[f"two_hop_{{phase}}_{{seed}}"] = run_info(
                ex.run(df2, src2, chaos=plan), plan)

# -- the sort resume, flat and grid
keys, payload = R.sort_inputs()
dfs = Dataflow.source().sort(key=lambda r: r["key"], num_buckets=8,
                             capacity_factor=3.0)
srcs = {{"key": jnp.asarray(keys), "payload": jnp.asarray(payload)}}
for tag, (mesh, axes) in (("flat", flat), ("grid", grid)):
    ex = SPMDExecutor(mesh, axes=axes)
    with mesh:
        for name, plan in (("clean", None), ("none", FaultPlan(kind="none")),
                           ("0_0", FaultPlan(kind="lose_device", phase=0,
                                             seed=0)),
                           ("0_1", FaultPlan(kind="lose_device", phase=0,
                                             seed=1)),
                           ("1_0", FaultPlan(kind="lose_device", phase=1,
                                             seed=0))):
            res = ex.run(dfs, srcs, chaos=plan)
            vr = res.valid_records()
            arr[f"sort_{{tag}}_{{name}}_key"] = np.asarray(vr["key"])
            arr[f"sort_{{tag}}_{{name}}_payload"] = np.asarray(vr["payload"])
            out[f"sort_{{tag}}_{{name}}"] = {{
                "dropped": int(res.dropped), "recoveries": res.recoveries,
                "events": list(plan.events) if plan is not None else []}}

# -- stream == batch, flat and grid
sdf = (Dataflow.stream_source().map(emit)
       .shuffle(by=lambda r: default_hash(r["key"], NB), num_buckets=NB)
       .reduce(count))
words = R.stream_words()
for tag, (mesh, axes) in (("flat", flat), ("grid", grid)):
    ex = StreamExecutor(SPMDExecutor(mesh, axes=axes), sdf,
                        micro_batch=R.MB, carry_capacity=32)
    with mesh:
        for i in range(R.K):
            ex.submit({{"word": words[i * R.MB:(i + 1) * R.MB]}})
            b = ex.step()
        out[f"stream_{{tag}}"] = {{
            "counts": counts(ex.carry_state()),
            "last_batch": counts(b.valid_records()),
            "cache": ex.inner.cache_info()._asdict()}}
        arr[f"stream_{{tag}}_carry_bytes"] = np.frombuffer(
            ex._checkpoint.to_bytes(), np.uint8)

# -- a device lost mid-stream
mesh, axes = flat
sched = ChaosSchedule([FaultPlan(kind="lose_device", at_batch=1)], seed=5)
queue = TenantQueue(quantum=float(R.MB))
vclock = {{"now": 0.0}}
ex = StreamExecutor(SPMDExecutor(mesh), sdf, micro_batch=R.MB,
                    carry_capacity=32, queue=queue,
                    clock=lambda: vclock["now"], chaos=sched)
words = R.device_loss_words()
tickets = [ex.submit({{"word": words[i*R.MB:(i+1)*R.MB]}}) for i in range(5)]
batches, step = [], 0
with mesh:
    while queue.pending():
        vclock["now"] = float(step)
        b = ex.step()
        if b is not None:
            batches.append([[t.req_id for t in b.delivered],
                            [t.req_id for t in b.requeued], b.dropped])
        step += 1
st = ex.stats()
out["device_loss"] = {{
    "counts": counts(ex.carry_state()), "events": list(sched.events),
    "batches": batches, "cache": st["cache"], "recoveries": st["recoveries"],
    "axis_size": ex.inner.axis_size,
    "tickets": [[t.requeues, t.attempts, t.completed_at] for t in tickets],
    "tenants": st["tenants"]}}

# -- streamed sort batches
mesh, axes = flat
sortdf = Dataflow.stream_source().sort(key=lambda r: r["key"],
                                       num_buckets=8, capacity_factor=3.0)
ex = StreamExecutor(SPMDExecutor(mesh), sortdf, micro_batch=8 * 64)
with mesh:
    for i, keys in enumerate(R.sort_batches()):
        ex.submit({{"key": keys, "payload": np.arange(8 * 64, dtype=np.int32)}})
        b = ex.step()
        vr = b.valid_records()
        arr[f"sorted_{{i}}_key"] = np.asarray(vr["key"])
        arr[f"sorted_{{i}}_payload"] = np.asarray(vr["payload"])
out["sorted_cache"] = ex.inner.cache_info()._asdict()

# -- per-stage traces
mesh, axes = flat
tr = Tracer()
with mesh:
    res = SPMDExecutor(mesh).run(df, src, trace=tr, trace_stages=True)
out["staged"] = {{"counts": counts(res.valid_records()),
                  "dropped": int(res.dropped),
                  "spans": sorted(sp.name for sp in tr.buffer.spans()
                                  if sp.name.startswith(("stage[", "hop[")))}}

# -- the stream-chaos soak, with and without its four faults
for tag, chaos in (("soak", True), ("soak_clean", False)):
    r = stream_chaos_bench.soak(chaos=chaos)
    out[tag] = {{k: r[k] for k in (
        "steps", "records_in", "batch_failures", "recoveries", "cache",
        "faults_fired", "events", "detector", "master", "requeues", "failed",
        "max_deliveries_per_request", "delivered_requests", "dropped",
        "stream_equals_batch", "end_devices")}}
    out[tag]["counts"] = sorted([int(k), int(v)]
                                for k, v in r["counts"].items())
with open({out_json!r}, "w") as f:
    json.dump(out, f)
np.savez({out_tmp!r}, **arr)
"""


def _run(d) -> None:
    tests = os.path.dirname(os.path.abspath(__file__))
    run_jax_8dev(_CODE.format(bench=BENCH, tests=tests,
                              out_json=str(d / "out.json"),
                              out_tmp=str(d / "out.tmp.npz")))
    os.replace(d / "out.tmp.npz", d / "out.npz")


_REFS = None


def stream_references(tmp_path_factory):
    """``(json dict, npz dict)`` of every reference (module docstring)."""
    global _REFS
    if _REFS is None:
        d = session_shared(tmp_path_factory, "torch_jax_stream_refs", _run)
        with open(d / "out.json") as f:
            out = json.load(f)
        _REFS = (out, dict(np.load(d / "out.npz")))
    return _REFS
