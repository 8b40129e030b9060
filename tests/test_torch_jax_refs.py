"""The JAX references of the port's multi-device tests, from ONE subprocess.

``tests/test_torch_shuffle.py`` and ``tests/test_torch_terasort.py`` hold
the port on ``Ranks(8, device="cpu")`` against the JAX package on 8
virtual CPU devices (Auto-axis mesh from ``repro.compat.make_mesh``).
Starting JAX with 8 devices and compiling its programs is most of their
cost, so one subprocess computes every reference both modules need and
writes it to an ``.npz``; :func:`jax_references` returns it, once per
process. Under pytest-xdist the workers of one session share that file
through a lock in the session's common temp directory, so the subprocess
runs once per session whichever workers the two modules land on.

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
             keys=keys, payload=payload, value=value)
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
        np.savez({str(d / "out.tmp.npz")!r}, **out)
    """)
    os.replace(d / "out.tmp.npz", d / "out.npz")


_REFS = None


def jax_references(tmp_path_factory) -> dict:
    """Every JAX reference of the shuffle and terasort tests, computed at
    most once per session (see the module docstring)."""
    global _REFS
    if _REFS is None:
        base = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            base = base.parent        # shared by the session's workers
        d = base / "torch_jax_refs"
        d.mkdir(exist_ok=True)
        with open(d / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not (d / "out.npz").exists():
                _run_references(d)
        _REFS = dict(np.load(d / "out.npz"))
    return _REFS
