"""The JAX references of the port's expert-parallel model tests, from ONE
subprocess.

``tests/test_torch_models.py`` holds the port's Sphere MoE dispatch and
grid prefill on ``Ranks(shape=(2, 4), ...)`` against the JAX package on 8
virtual CPU devices (Auto-axis meshes from ``repro.compat.make_mesh``):
the flat ``("data", "model")`` dispatch, the wide-area ``("dc",
"node")`` one, a dispatch that drops at the published capacity factor,
the grid prefill of a two-layer MoE model, and which shapes make the
JAX package's dispatch fail. One subprocess computes them all, once per
session (shared by the xdist workers through
:func:`test_torch_jax_refs.session_shared`).

The subprocess runs XLA with ``--xla_allow_excess_precision=false``: by
default XLA may keep a bfloat16 intermediate of a compiled function in
float32, so the JAX package's compiled results differ from its own
op-by-op results (up to 0.0625 on the smoke models' logits). With the
flag the compiled functions round every op to the dtype the program
names, as the port does, and the comparisons can be tight.

Inputs are this module's functions (numpy, seeded); the weights are the
JAX package's ``init`` at ``PRNGKey(0)``, which the test process draws
again. This module holds no tests of its own.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np

from test_torch_jax_refs import SRC, session_shared

#: (tag, mesh axes, weights' tp, capacity_factor, x shape) of the sphere
#: dispatch cases: the bodies of tests/test_spmd.py's and
#: tests/test_hier_shuffle.py's MoE tests, and one that drops
MOE_CASES = (
    ("flat", ("data", "model"), 4, 8.0, (4, 16)),
    ("hier", ("dc", "node"), 8, 8.0, (4, 16)),
    ("flat_cf125", ("data", "model"), 4, 1.25, (4, 64)),
)
MOE_ARCH = "qwen3_moe_30b_a3b"

#: the grid prefill: qwen2-moe smoke with 16 experts (so the (2, 4) grid
#: pads them as the weights do), no drops
PREFILL_ARCH = "qwen2_moe_a2_7b"
PREFILL_EXPERTS = 16
PREFILL_CF = 8.0
PREFILL_SHAPE = (2, 16)
PREFILL_MAX_LEN = 24

#: (arch, num_experts override or 0, mesh shape, mesh axes): where does
#: the JAX package's sphere dispatch fail? (finding 2: the weights pad
#: the experts to 16, the dispatch to the expert axis size)
RAISE_CASES = (
    ("qwen2_moe_a2_7b", 0, (2, 4), ("data", "model")),
    ("qwen2_moe_a2_7b", 0, (1, 8), ("data", "model")),
    ("qwen3_moe_30b_a3b", 0, (2, 4), ("data", "model")),
    ("qwen2_moe_a2_7b", 16, (2, 4), ("data", "model")),
    ("qwen2_moe_a2_7b", 60, (2, 4), ("data", "model")),
    ("qwen2_moe_a2_7b", 60, (1, 8), ("data", "model")),
    ("qwen2_moe_a2_7b", 60, (2, 4), ("dc", "node")),
    ("qwen3_moe_30b_a3b", 0, (2, 4), ("dc", "node")),
)


def moe_input(shape, d_model, seed=1):
    """float32 values; both packages round them to bfloat16 (to nearest
    even) before use."""
    return np.random.default_rng(seed).standard_normal(
        shape + (d_model,)).astype(np.float32)


def prefill_tokens(vocab):
    return np.random.default_rng(2).integers(
        0, vocab, size=PREFILL_SHAPE).astype(np.int32)


def _run(d) -> None:
    code = f"""
        import dataclasses
        import numpy as np, jax, jax.numpy as jnp
        from repro.compat import make_mesh
        from repro.configs import get_smoke_config
        from repro.models import build, moe as moe_mod
        from repro.models.transformer import lm_forward
        import test_torch_jax_model_refs as R
        out = {{}}
        for tag, axes, tp, cf, shape in R.MOE_CASES:
            cfg = dataclasses.replace(get_smoke_config(R.MOE_ARCH),
                                      capacity_factor=cf)
            params, _ = moe_mod.moe_init(jax.random.PRNGKey(0), cfg, tp=tp)
            x = jnp.asarray(R.moe_input(shape, cfg.d_model), jnp.bfloat16)
            mesh = make_mesh((2, 4), axes)
            dp, ep = (("data",), None) if axes[0] == "data" else ((), axes)
            with mesh:
                o, a = jax.jit(lambda p, x: moe_mod.moe_apply_sphere(
                    p, x, cfg, mesh, dp, ep_axes=ep))(params, x)
            out[tag + "_out"] = np.asarray(o.astype(jnp.float32))
            out[tag + "_aux"] = np.asarray(a["moe_aux"])
            out[tag + "_dropped"] = np.asarray(a["moe_dropped"])

        cfg = dataclasses.replace(get_smoke_config(R.PREFILL_ARCH),
                                  num_experts=R.PREFILL_EXPERTS,
                                  capacity_factor=R.PREFILL_CF)
        model = build(cfg)
        params, _ = model.init(jax.random.PRNGKey(0))
        mesh = make_mesh((2, 4), ("data", "model"))
        toks = jnp.asarray(R.prefill_tokens(cfg.vocab))
        caches = model.init_caches(toks.shape[0], R.PREFILL_MAX_LEN)
        with mesh:
            lg, caches, aux = lm_forward(params, cfg, toks, caches=caches,
                                         mesh=mesh, last_only=True)
        out["prefill_logits"] = np.asarray(lg)
        out["prefill_pos"] = np.asarray(caches["pos"])
        out["prefill_k"] = np.asarray(caches["k"].astype(jnp.float32))
        out["prefill_aux"] = np.asarray(aux["moe_aux"])
        out["prefill_dropped"] = np.asarray(aux["moe_dropped"])

        raises = []
        for arch, ne, shape, axes in R.RAISE_CASES:
            cfg = get_smoke_config(arch)
            if ne:
                cfg = dataclasses.replace(cfg, num_experts=ne)
            params, _ = moe_mod.moe_init(jax.random.PRNGKey(0), cfg)
            x = jax.ShapeDtypeStruct((8, 16, cfg.d_model), jnp.bfloat16)
            mesh = make_mesh(shape, axes)
            ep = None if axes[0] == "data" else axes
            dp = ("data",) if axes[0] == "data" else ()
            try:
                with mesh:
                    jax.eval_shape(lambda p, x: moe_mod.moe_apply_sphere(
                        p, x, cfg, mesh, dp, ep_axes=ep), params, x)
                raises.append(False)
            except ValueError:
                raises.append(True)
        out["raises"] = np.array(raises)
        np.savez({str(d / "out.tmp.npz")!r}, **out)
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_allow_excess_precision=false")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, os.path.dirname(__file__), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nERR:\n{proc.stderr}"
    os.replace(d / "out.tmp.npz", d / "out.npz")


_REFS = None


def model_references(tmp_path_factory) -> dict:
    """Every grid reference of the model tests, computed at most once per
    session."""
    global _REFS
    if _REFS is None:
        d = session_shared(tmp_path_factory, "torch_jax_model_refs", _run)
        _REFS = dict(np.load(d / "out.npz"))
    return _REFS
