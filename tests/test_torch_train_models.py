"""The port's ``train_loss`` and its gradients against the JAX package's
``jax.value_and_grad``, for every family's smoke config, on the CPU; and
the Motivation's grid case: on a ``(2, 4)`` ``("data", "model")`` grid
the bucket shuffle frames records into bytes, which neither package
differentiates, so the routed experts get no gradient.

The weights are the JAX package's ``init`` at ``PRNGKey(0)`` in float32
(``params_from_numpy(..., dtype=torch.float32)``); inputs are numpy with
a seed, float inputs rounded to bfloat16 in both. The JAX functions are
compiled with XLA's excess precision off. Tolerances, stated once:

- the loss: ``ATOL_LOSS`` 1e-3 (the smoke models' logits agree but for a
  bfloat16 ulp here and there, tests/test_torch_models.py; measured up
  to 6.8e-4, internvl2);
- every gradient leaf: max error <= ``RTOL_GRAD`` 3% of the leaf's
  largest value plus ``ATOL_GRAD`` 1e-3: the backward's products round
  in bfloat16 in another order than XLA's (measured 0.8-2% of the
  leaf's largest value; zamba2's ``d_skip`` sums many terms that cancel,
  and its error is 4.9e-4 against a largest value of 1.5e-3);
- the whole gradient: norm of the error <= ``RTOL_NORM`` 2% of the norm.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build as jax_build
from repro_torch.comm import Ranks
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops as kops
from repro_torch.models import build, ssm
from repro_torch.models.convert import flatten, params_from_numpy
from repro_torch.train.trainer import loss_and_grads

from test_torch_jax_refs import SRC, session_shared

NO_EXCESS = {"xla_allow_excess_precision": False}
ATOL_LOSS = 1e-3
RTOL_GRAD = 0.03
ATOL_GRAD = 1e-3
RTOL_NORM = 0.02
KEY = jax.random.PRNGKey(0)

#: one smoke config a family (moe: the dense dispatch, no ranks)
FAMILIES = {"dense": "tinyllama_1_1b", "moe": "qwen2_moe_a2_7b",
            "mla": "minicpm3_4b", "ssm": "xlstm_125m",
            "hybrid": "zamba2_1_2b", "vlm": "internvl2_1b",
            "audio": "whisper_small"}

#: the grid case: qwen2-moe smoke with 16 experts on (2, 4)
GRID_ARCH = "qwen2_moe_a2_7b"
GRID_EXPERTS = 16
GRID_SHAPE = (4, 16)
ROUTED = ("w_gate", "w_up", "w_down")


def batch_arrays(cfg, shape=(2, 16), seed=1):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, shape).astype(np.int32)}
    if cfg.family == "vlm":
        b["img_embeds"] = rng.standard_normal(
            (shape[0], cfg.img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (shape[0], cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return b


def both(b):
    """The batch for each package: float inputs as bfloat16."""
    jb = {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else None)
          for k, v in b.items()}
    tb = {k: (torch.from_numpy(v).bfloat16() if v.dtype == np.float32
              else torch.from_numpy(v)) for k, v in b.items()}
    return jb, tb


def assert_grads_close(grads, want):
    errs, norms = 0.0, 0.0
    for name, g in grads.items():
        w = want[name]
        got = np.zeros_like(w) if g is None else g.numpy()
        err = np.abs(got - w).max()
        assert err <= RTOL_GRAD * np.abs(w).max() + ATOL_GRAD, name
        errs += float(np.sum((got - w) ** 2))
        norms += float(np.sum(w.astype(np.float64) ** 2))
    assert np.sqrt(errs) <= RTOL_NORM * np.sqrt(norms)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_loss_and_gradients_match_jax(family):
    arch = FAMILIES[family]
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jmodel, model = jax_build(jcfg), build(cfg)
    jparams, _ = jmodel.init(KEY)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu",
                               dtype=torch.float32)
    jb, tb = both(batch_arrays(cfg))
    f = jax.value_and_grad(lambda p, b: jmodel.train_loss(p, b),
                           has_aux=True)
    (jloss, jmet), jgrads = jax.jit(f).lower(jparams, jb).compile(
        NO_EXCESS)(jparams, jb)
    loss, metrics, grads = loss_and_grads(model, params, tb)
    assert abs(float(loss) - float(jloss)) <= ATOL_LOSS
    assert set(metrics) == set(jmet)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]),
                                   atol=ATOL_LOSS)
    assert list(grads) == list(flatten(jgrads))       # the JAX leaf order
    assert all(g is not None for g in grads.values())
    assert_grads_close(grads, flatten(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jgrads)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_input_specs_match_jax(family, shape_name):
    """``Model.input_specs``: the JAX package's shapes and dtypes, without
    its sharding."""
    arch = FAMILIES[family]
    want = jax_build(jax_smoke_config(arch)).input_specs(shape_name)
    got = build(get_smoke_config(arch)).input_specs(shape_name)
    assert list(got) == list(want)
    for k, (shape, dtype) in got.items():
        assert tuple(shape) == tuple(want[k].shape), k
        assert str(dtype).split(".")[-1] == str(want[k].dtype), k


def test_remat_changes_no_gradient():
    """``cfg.remat`` recomputes every block in the backward: the same
    loss and gradients to the bit as keeping the activations."""
    cfg = get_smoke_config("qwen2_moe_a2_7b")
    _, tb = both(batch_arrays(cfg))
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model = build(c)
        params = model.init(torch.Generator().manual_seed(0), "cpu",
                            dtype=torch.float32)
        out.append(loss_and_grads(model, params, tb))
    (l1, m1, g1), (l2, m2, g2) = out
    assert torch.equal(l1, l2) and m1.keys() == m2.keys()
    for n in g1:
        assert torch.equal(g1[n], g2[n]), n


def test_ssd_block_in_place_and_out_of_place_forms_agree():
    """The chunk scan's decay weights: in place without gradients (no
    second float32 buffer), out of place with them (autograd keeps
    ``exp``'s output); the same bits."""
    g = torch.Generator().manual_seed(0)
    B, L, H, P, N, Q = 2, 20, 3, 4, 5, 8
    xs = torch.randn(B, L, H, P, generator=g).bfloat16()
    Bs = torch.randn(B, L, N, generator=g).bfloat16()
    Cs = torch.randn(B, L, N, generator=g).bfloat16()
    dt = torch.rand(B, L, H, generator=g) * 0.1
    A = -torch.rand(H, generator=g)
    d_skip = torch.randn(H, generator=g)
    with torch.inference_mode():
        y0, s0 = ssm._ssd_chunked(xs, Bs, Cs, dt, A, d_skip, Q)
    dt.requires_grad_(True)
    y1, s1 = ssm._ssd_chunked(xs, Bs, Cs, dt, A, d_skip, Q)
    assert torch.equal(y0, y1.detach()) and torch.equal(s0, s1.detach())
    (y1.float().sum() + s1.sum()).backward()
    assert dt.grad is not None and torch.isfinite(dt.grad).all()


# -- the (2, 4) grid -------------------------------------------------------------


def grid_batch(vocab):
    return batch_arrays(type("C", (), {"vocab": vocab, "family": "moe"}),
                        GRID_SHAPE, seed=2)


def _run_grid_reference(d) -> None:
    code = f"""
        import dataclasses
        import numpy as np, jax, jax.numpy as jnp
        from repro.compat import make_mesh
        from repro.configs import get_smoke_config
        from repro.models import build
        import test_torch_train_models as R
        cfg = dataclasses.replace(get_smoke_config(R.GRID_ARCH),
                                  num_experts=R.GRID_EXPERTS)
        model = build(cfg)
        params, _ = model.init(jax.random.PRNGKey(0))
        b = {{k: jnp.asarray(v) for k, v in R.grid_batch(cfg.vocab).items()}}
        mesh = make_mesh((2, 4), ("data", "model"))
        f = jax.value_and_grad(
            lambda p, b: model.train_loss(p, b, mesh=mesh), has_aux=True)
        with mesh:
            (loss, met), g = jax.jit(f)(params, b)
        out = {{"loss": np.asarray(loss),
               "moe_aux": np.asarray(met["moe_aux"]),
               "moe_dropped": np.asarray(met["moe_dropped"])}}
        paths = jax.tree_util.tree_flatten_with_path(g)[0]
        for path, leaf in paths:
            name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
            out["grad." + name] = np.asarray(leaf, np.float32)
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


@pytest.fixture(scope="module")
def grid_ref(tmp_path_factory):
    d = session_shared(tmp_path_factory, "torch_jax_train_refs",
                       _run_grid_reference)
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def grid_model():
    jcfg = dataclasses.replace(jax_smoke_config(GRID_ARCH),
                               num_experts=GRID_EXPERTS)
    cfg = dataclasses.replace(get_smoke_config(GRID_ARCH),
                              num_experts=GRID_EXPERTS)
    jparams, _ = jax_build(jcfg).init(KEY)
    return cfg, jax.tree.map(np.asarray, jparams)


def test_grid_train_step_gives_routed_experts_no_gradient(grid_ref,
                                                          grid_model,
                                                          monkeypatch):
    """On the (2, 4) grid both packages give the routed experts no
    gradient (JAX: zeros; the port: ``None``), the router one through
    ``moe_aux`` only, and the shared experts, attention and embedding
    theirs; K1 runs four times a MoE layer (twice in the forward, twice
    in the remat recompute)."""
    cfg, tree = grid_model
    params = params_from_numpy(tree, cfg, "cpu", dtype=torch.float32)
    model = build(cfg)
    rk = Ranks(shape=(2, 4), axes=("data", "model"), device="cpu")
    _, tb = both(grid_batch(cfg.vocab))
    calls = []
    real = kops.partition_rank
    monkeypatch.setattr(kops, "partition_rank",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss, metrics, grads = loss_and_grads(model, params, tb, rk)
    assert len(calls) == 4 * cfg.num_layers
    assert abs(float(loss) - float(grid_ref["loss"])) <= ATOL_LOSS
    np.testing.assert_allclose(float(metrics["moe_aux"]),
                               float(grid_ref["moe_aux"]), atol=ATOL_LOSS)
    assert float(metrics["moe_dropped"]) == float(grid_ref["moe_dropped"])
    want = {k[len("grad."):]: v for k, v in grid_ref.items()
            if k.startswith("grad.")}
    want = flatten(_nest(want))
    assert list(grads) == list(want)
    for name, g in grads.items():
        if name.split(".")[-1] in ROUTED:
            assert g is None and not want[name].any(), name
        else:
            assert g is not None and g.abs().max() > 0, name
    router = {n: g for n, g in grads.items() if n.endswith("router")}
    assert max(float(g.abs().max()) for g in router.values()) < 0.01
    assert_grads_close(grads, want)
    # without the grid (the dense dispatch) every expert gets a gradient
    _, _, dense = loss_and_grads(model, params, tb)
    for name, g in dense.items():
        if name.split(".")[-1] in ROUTED:
            assert g is not None and g.abs().max() > 0, name


def _nest(flat):
    """``{"a.b.c": v}`` -> nested dicts (the stacked blocks as arrays)."""
    out = {}
    for name, v in flat.items():
        node = out
        parts = name.split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return out
