"""The JAX references of the port's multi-device tests, from ONE subprocess.

``tests/test_torch_shuffle.py``, ``tests/test_torch_terasort.py``,
``tests/test_torch_hier_shuffle.py`` and ``tests/test_torch_mapreduce.py``
hold the port on ``Ranks(8, device="cpu")`` (or the ``(dc, node) = (2,
4)`` grid) against the JAX package on 8 virtual CPU devices (Auto-axis
meshes from ``repro.compat.make_mesh``). Starting JAX with 8 devices and
compiling its programs is most of their cost, so one subprocess computes
every reference these modules need and writes it to an ``.npz``;
:func:`jax_references` returns it, once per process. Under pytest-xdist
the workers of one session share that file through a lock in the
session's common temp directory, so the subprocess runs once per session
whichever workers the modules land on.

This module holds no tests of its own.
"""

import fcntl
import os
import subprocess
import sys
import textwrap

import numpy as np

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# -- the flat shuffle (tests/test_torch_shuffle.py) ----------------------------

N_SHUFFLE = 8 * 512
CAP = 40  # ~64 records per (source, destination): capacity pressure

# -- the whole slice (tests/test_torch_terasort.py) ----------------------------

N = 8 * 2048
N_RADIX = 8 * 256
N_BYTES = 8 * 1024

#: a map -> shuffle -> reduce pipeline whose UDFs are the same source text
#: for both packages (arithmetic operators only).
MSR_SRC = ("Dataflow.source()"
           ".map(lambda r: {'k': r['k'], 'v': r['v'] * 2})"
           ".shuffle(by=lambda r: r['k'] % 16, num_buckets=16, "
           "capacity_factor=1.1)"
           ".reduce(lambda r, v: (r, v))")


# -- the wide-area (dc, node) shuffle (tests/test_torch_hier_shuffle.py) --------

CAP_A, CAP_B = 120, 230     # n_local 512 over 4 nodes / 2 DCs: some drops
#: (wire_meta, chunks) cases of the hierarchical shuffle
HIER_CASES = (("full", 1), ("full", 2), ("min", 1))

# -- MapReduce (tests/test_torch_mapreduce.py) ----------------------------------

N_WORDS = 8 * 1024
VOCAB = 1 << 10

#: the wordcount pipeline, the same source text for both packages
#: (``ALGO`` pins the reduce's sort).
WORDCOUNT_SRC = (
    "Dataflow.source()"
    ".map(lambda r: {'key': r['word'], 'value': r['word'] * 0 + 1})"
    ".shuffle(by=lambda r: default_hash(r['key'], 8), num_buckets=8)"
    ".reduce(lambda r, v: (lambda k, s, d: ({'key': k, 'value': s}, "
    "k >= 0, d))(*reduce_by_key_sum(r['key'], r['value'], v, algo=ALGO)))")


def word_inputs():
    """Word ids: Zipf exponent 1.1 folded into a ``VOCAB``-word vocabulary
    (the shape of ``chip_smoke.py``'s wordcount input, smaller)."""
    rng = np.random.default_rng(3)
    return ((rng.zipf(1.1, size=N_WORDS) - 1) % VOCAB).astype(np.int32)


def shuffle_inputs():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 1000, size=(N_SHUFFLE, 3)).astype(np.int32)
    buckets = rng.integers(-1, 16, size=N_SHUFFLE).astype(np.int32)
    valid = rng.random(N_SHUFFLE) > 0.05
    return data, buckets, valid


def terasort_inputs():
    """The keys of ``tests/test_spmd.py:35``, an index payload and 96-byte
    values."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**31 - 2, size=N).astype(np.int32)
    payload = np.arange(N, dtype=np.int32)
    value = rng.integers(0, 256, size=(N_BYTES, 96)).astype(np.uint8)
    return keys, payload, value


def run_jax_8dev(code: str, timeout: int = 600) -> None:
    """Run ``code`` in a fresh interpreter that sees 8 CPU devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nERR:\n{proc.stderr}"


def _run_references(d) -> None:
    data, buckets, valid = shuffle_inputs()
    keys, payload, value = terasort_inputs()
    np.savez(d / "in.npz", data=data, buckets=buckets, valid=valid,
             keys=keys, payload=payload, value=value, words=word_inputs())
    run_jax_8dev(f"""
        import numpy as np, jax, jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.compat import make_mesh, shard_map
        from repro.core.shuffle import sphere_shuffle
        from repro.core.sort import (terasort, hadoop_style_sort,
                                     sampled_splitters)
        from repro.sphere.dataflow import Dataflow, SPMDExecutor
        MSR = {MSR_SRC}
        mesh = make_mesh((8,), ("data",))
        sh = NamedSharding(mesh, P("data"))
        src = np.load({str(d / "in.npz")!r})
        put = lambda a: jax.device_put(jnp.asarray(a), sh)
        out = {{}}

        # the flat shuffle at chunks 1 and 4
        args = [put(src[k]) for k in ("data", "buckets", "valid")]
        for chunks in (1, 4):
            def udf(x, b, v):
                r = sphere_shuffle(x, b.reshape(-1), 16, {CAP}, "data",
                                   valid=v.reshape(-1), chunks=chunks)
                return (r.data.reshape(-1, 3), r.valid.reshape(-1),
                        r.bucket.reshape(-1), r.src_pos.reshape(-1),
                        r.dropped)
            with mesh:
                res = jax.jit(shard_map(
                    udf, mesh=mesh, in_specs=(P("data"),) * 3,
                    out_specs=(P("data"),) * 4 + (P(),),
                    check_vma=False))(*args)
            for name, a in zip(("data", "valid", "bucket", "src", "dropped"),
                               res):
                out[f"shuffle_{{name}}{{chunks}}"] = np.asarray(a)

        # the whole slice
        def save(tag, res):
            for f in ("keys", "payload", "valid", "dropped"):
                out[f"{{tag}}_{{f}}"] = np.asarray(getattr(res, f))
        k, p = put(src["keys"]), put(src["payload"])
        with mesh:
            save("bitonic", terasort(k, p, mesh, use_pallas=True))
            save("bpd4", terasort(k, p, mesh, use_pallas=True,
                                  buckets_per_device=4))
            kr, pr = put(src["keys"][:{N_RADIX}]), put(src["payload"][:{N_RADIX}])
            save("radix", terasort(kr, pr, mesh, sort_algo="radix"))
            save("hadoop", hadoop_style_sort(kr, pr, mesh))
            recs = {{"key": put(src["keys"][:{N_BYTES}]),
                     "value": put(src["value"])}}
            df = Dataflow.source().sort(key=lambda r: r["key"],
                                        num_buckets=8)
            res = SPMDExecutor(mesh, sort_algo="bitonic").run(df, recs)
            out["bytes_key"] = np.asarray(res.records["key"])
            out["bytes_value"] = np.asarray(res.records["value"])
            out["bytes_valid"] = np.asarray(res.valid)
            out["bytes_dropped"] = np.asarray(res.dropped)
            # the sentinel guard: raises for bitonic, not for radix
            kmax = src["keys"][:{N_RADIX}].copy()
            kmax[::97] = np.iinfo(np.int32).max
            try:
                terasort(put(kmax), pr, mesh, use_pallas=True)
                out["guard_bitonic"] = np.array(False)
            except ValueError:
                out["guard_bitonic"] = np.array(True)
            save("guard_radix", terasort(put(kmax), pr, mesh,
                                         sort_algo="radix"))
            out["sampled"] = np.asarray(sampled_splitters(
                k, 16, 64, mesh))
            # map -> shuffle (under capacity pressure) -> reduce
            recs = {{"k": put(src["keys"][:{N_BYTES}] % 1000),
                     "v": put(src["payload"][:{N_BYTES}])}}
            res = SPMDExecutor(mesh).run(MSR, recs)
            out["msr_k"] = np.asarray(res.records["k"])
            out["msr_v"] = np.asarray(res.records["v"])
            out["msr_valid"] = np.asarray(res.valid)
            out["msr_dropped"] = np.asarray(res.dropped)

        # -- the wide-area (dc, node) grid --------------------------------
        from repro.core.shuffle import (ShufflePlan, hierarchical_shuffle,
                                        hierarchical_combine, sphere_combine)
        from repro.core.introspect import collective_counts
        from repro.core.mapreduce import (default_hash, map_reduce,
                                          reduce_by_key_sum)
        from repro.core.stream import make_stream
        from repro.core.udf import sphere_map
        import dataclasses
        mesh2 = make_mesh((2, 4), ("dc", "node"))
        s2 = P(("dc", "node"))
        sh2 = NamedSharding(mesh2, s2)
        put2 = lambda a: jax.device_put(jnp.asarray(a), sh2)
        args2 = [put2(src[k]) for k in ("data", "buckets", "valid")]
        hier_fields = ("data", "valid", "bucket", "src_pos", "b_pos",
                       "a_valid", "a_src")
        for wire_meta, chunks in {HIER_CASES!r}:
            def udf(x, b, v):
                r = hierarchical_shuffle(
                    x, b.reshape(-1), 16, {CAP_A}, {CAP_B}, "dc", "node",
                    valid=v.reshape(-1), chunks=chunks, wire_meta=wire_meta)
                outs = [getattr(r, f) for f in hier_fields]
                outs = [jnp.zeros((1,), jnp.int32) if o is None else o
                        for o in outs]
                return tuple(outs) + (r.dropped,)
            with mesh2:
                res = jax.jit(shard_map(
                    udf, mesh=mesh2, in_specs=(s2,) * 3,
                    out_specs=(s2,) * 7 + (P(),), check_vma=False))(*args2)
            tag = f"hier_{{wire_meta}}{{chunks}}"
            for name, a in zip(hier_fields + ("dropped",), res):
                out[f"{{tag}}_{{name}}"] = np.asarray(a)

        # combines: int32 results (data * 3) routed back to the origin rows
        def hier_round(x, b, v):
            r = hierarchical_shuffle(x, b.reshape(-1), 16, {CAP_A}, {CAP_B},
                                     "dc", "node", valid=v.reshape(-1))
            return hierarchical_combine(r.data * 3, r, "dc", "node",
                                        x.shape[0])
        def flat_round(x, b, v):
            r = sphere_shuffle(x, b.reshape(-1), 16, {CAP}, "data",
                               valid=v.reshape(-1))
            return sphere_combine(r.data * 3, r, "data", x.shape[0])
        with mesh2:
            c, h = jax.jit(shard_map(hier_round, mesh=mesh2,
                                     in_specs=(s2,) * 3, out_specs=(s2, s2),
                                     check_vma=False))(*args2)
        out["hcombine_out"], out["hcombine_hits"] = np.asarray(c), np.asarray(h)
        with mesh:
            c, h = jax.jit(shard_map(flat_round, mesh=mesh,
                                     in_specs=(P("data"),) * 3,
                                     out_specs=(P("data"),) * 2,
                                     check_vma=False))(*args)
        out["fcombine_out"], out["fcombine_hits"] = np.asarray(c), np.asarray(h)

        # the collective counts of every hop kind (traced, not run)
        flat_p = ShufflePlan.for_mesh(mesh, 16, 512, 2.5, ("data",))
        hier_p = ShufflePlan.for_mesh(mesh2, 16, 512, 2.5, ("dc", "node"))
        d0, b0 = jnp.zeros((4096, 3), jnp.int32), jnp.zeros((4096,), jnp.int32)
        def counts(plan, m, spec, combine):
            def f(d, b):
                r = plan.shuffle(d, b.reshape(-1))
                if combine:
                    return plan.combine(r.data * 2, r, 512)
                return r.data, r.valid
            g = shard_map(f, mesh=m, in_specs=(spec, spec),
                          out_specs=(spec, spec), check_vma=False)
            c = collective_counts(g, d0, b0)
            return np.array([c["all_to_all"], c["all_gather"]])
        for kind, plan, m, spec in (("flat", flat_p, mesh, P("data")),
                                    ("hier", hier_p, mesh2, s2)):
            for w in (1, 2, 4):
                pw = dataclasses.replace(plan, chunks=w)
                out[f"count_{{kind}}{{w}}"] = counts(pw, m, spec, False)
            out[f"count_{{kind}}_combine"] = counts(plan, m, spec, True)

        # terasort and the 100-byte Dataflow sort on the grid
        k2, p2 = put2(src["keys"]), put2(src["payload"])
        with mesh2:
            save("hier_bitonic", terasort(k2, p2, mesh2, axis=("dc", "node"),
                                          use_pallas=True))
            save("hier_radix", terasort(put2(src["keys"][:{N_RADIX}]),
                                        put2(src["payload"][:{N_RADIX}]),
                                        mesh2, axis=("dc", "node"),
                                        sort_algo="radix"))
            recs = {{"key": put2(src["keys"][:{N_BYTES}]),
                     "value": put2(src["value"])}}
            df = Dataflow.source().sort(key=lambda r: r["key"],
                                        num_buckets=8)
            res = SPMDExecutor(mesh2, axes=("dc", "node"),
                               sort_algo="bitonic").run(df, recs)
            out["hbytes_key"] = np.asarray(res.records["key"])
            out["hbytes_value"] = np.asarray(res.records["value"])
            out["hbytes_valid"] = np.asarray(res.valid)
            out["hbytes_dropped"] = np.asarray(res.dropped)

        # wordcount on the flat mesh and on the grid
        WC = eval({WORDCOUNT_SRC!r}, {{"Dataflow": Dataflow,
                                      "default_hash": default_hash,
                                      "reduce_by_key_sum": reduce_by_key_sum,
                                      "ALGO": "oracle"}})
        for tag, m, ax, pt in (("wc_flat", mesh, ("data",), put),
                               ("wc_hier", mesh2, ("dc", "node"), put2)):
            with m:
                res = SPMDExecutor(m, axes=ax).run(WC, {{"word": pt(src["words"])}})
            out[f"{{tag}}_key"] = np.asarray(res.records["key"])
            out[f"{{tag}}_value"] = np.asarray(res.records["value"])
            out[f"{{tag}}_valid"] = np.asarray(res.valid)
            out[f"{{tag}}_dropped"] = np.asarray(res.dropped)

        # the deprecated map_reduce shim, with max_unique truncation drops
        with mesh:
            mk, mv, mval, mdrop = map_reduce(
                lambda seg: (seg % 300, seg * 0 + 1),
                lambda k, v, ok: reduce_by_key_sum(k, v, ok, max_unique=20,
                                                   algo="oracle"),
                put(src["words"]), mesh, num_buckets=8)
        out["mr_key"], out["mr_value"] = np.asarray(mk), np.asarray(mv)
        out["mr_valid"], out["mr_dropped"] = np.asarray(mval), np.asarray(mdrop)

        # sphere_map: record-wise with validity, whole-segment, two streams,
        # and a replicated output
        st = make_stream(src["data"], mesh)
        st = dataclasses.replace(st, valid=put(src["valid"]))
        r1 = sphere_map(lambda x: x * 2 + 1, st, mesh)
        out["smap_rec"], out["smap_rec_valid"] = (np.asarray(r1.data),
                                                  np.asarray(r1.valid))
        r2 = sphere_map(lambda x: x.sum(axis=0, keepdims=True), st, mesh)
        out["smap_seg"] = np.asarray(r2.data)
        out["smap_seg_valid"] = np.array(r2.valid is None)
        r3 = sphere_map(lambda a, b: a - b[:, :1], [st, make_stream(
            src["data"] * 5, mesh)], mesh)
        out["smap_two"] = np.asarray(r3.data)
        r4 = sphere_map(lambda x: x[:2] * 0 + 7, st, mesh, out_axis=None)
        out["smap_rep"] = np.asarray(r4.data)
        np.savez({str(d / "out.tmp.npz")!r}, **out)
    """)
    os.replace(d / "out.tmp.npz", d / "out.npz")


_REFS = None


def session_shared(tmp_path_factory, name: str, runner) -> "os.PathLike":
    """The directory ``name`` of the session's common temp directory after
    ``runner(directory)`` has filled it — at most once per session, under
    a lock, whichever xdist worker asks first. ``runner`` must leave
    ``out.npz`` there last (written under another name, then renamed)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent        # shared by the session's workers
    d = base / name
    d.mkdir(exist_ok=True)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "out.npz").exists():
            runner(d)
    return d


def jax_references(tmp_path_factory) -> dict:
    """Every JAX reference of the shuffle and terasort tests, computed at
    most once per session (see the module docstring)."""
    global _REFS
    if _REFS is None:
        d = session_shared(tmp_path_factory, "torch_jax_refs",
                           _run_references)
        _REFS = dict(np.load(d / "out.npz"))
    return _REFS
