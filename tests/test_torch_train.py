"""The port's optimizer and train step against the JAX package, on the CPU.

Inputs come from numpy with a seed; the model weights are the JAX
package's ``init`` at ``PRNGKey(0)``, carried across in float32
(``params_from_numpy(..., dtype=torch.float32)``). The JAX functions are
compiled with XLA's excess precision off (see
``tests/test_torch_models.py``). Tolerances, stated once:

- ``lr_schedule``: ``RTOL_LR`` 1e-6 relative, 8 float32 ulps (measured
  7): XLA rewrites ``step / warmup`` as ``step * (1 / warmup)`` and
  contracts multiply-adds into FMAs, where the port rounds every op as
  the program names it; XLA's and torch's ``cos`` differ by an ulp.
- ``adamw_update`` on random trees: ``RTOL_UPDATE`` 1e-6 relative to the
  leaf's largest value (XLA contracts ``b * m + (1 - b) * g`` into an
  FMA on this CPU, torch rounds each op; ``pow`` and ``sqrt`` of the bias
  corrections may differ by an ulp) and the global norm to 1e-6
  relative (its leaf sums reduce in another order).
- five train steps of smoke TinyLlama: each loss within ``ATOL_LOSS``
  2e-3 of the JAX package's (bfloat16 products, about one ulp a
  logit), every parameter within ``2 * sum(lr)`` of it (AdamW's first
  steps move a weight by about ``lr * sign(g)``, so a gradient that
  rounds to the other sign moves it by ``2 lr``), 99% of them within
  ``0.05 * sum(lr)`` and half within ``0.005 * sum(lr)``: AdamW divides
  ``m`` by ``sqrt(v)``, so the gradients' rounding differences (about 1%
  in bfloat16, tests/test_torch_train_models.py) become that share of a
  step (measured: median 0.0026, 99% 0.027 of ``sum(lr)`` after five
  steps).
- gradient accumulation: as the five steps; against one big batch,
  within 5e-3 (``tests/test_train.py``'s bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SectorDataPipeline as JaxPipeline
from repro.data import synthetic_tokens as jax_synthetic_tokens
from repro.data import upload_token_dataset as jax_upload
from repro.launch.train import make_sector as jax_make_sector
from repro.models import build as jax_build
from repro.train import optimizer as jopt
from repro.train.trainer import build_train_step as jax_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launch_train
from repro_torch.models import build
from repro_torch.models.convert import flatten, named_leaves, params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import build_train_step

NO_EXCESS = {"xla_allow_excess_precision": False}
RTOL_LR = 1e-6
RTOL_UPDATE = 1e-6
ATOL_LOSS = 2e-3
KEY = jax.random.PRNGKey(0)


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(NO_EXCESS)


# -- lr schedule ---------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110),
    topt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=16),
    topt.AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=1000,
                     min_lr_ratio=0.0),
], ids=["warmup10", "launcher16", "nowarmup"])
def test_lr_schedule_matches_jax(cfg):
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: jopt.lr_schedule(jcfg, s)))(jnp.asarray(steps)))
    got = np.array([float(topt.lr_schedule(cfg, torch.tensor(int(s))))
                    for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL_LR, atol=0)
    assert got.dtype == np.float32


# -- adamw_update on random trees --------------------------------------------------


def random_tree(rng):
    """A nested tree of the JAX package's kinds: a stacked 3-d leaf, a
    vector, a matrix, and ``z``, which gets no gradient."""
    shapes = {"a": {"w": (3, 4, 5), "b": (7,)}, "c": (6, 2), "z": (4,)}
    return jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


def flat_jax_order(tree):
    """``{dotted path: leaf}`` in ``jax.tree.leaves`` order."""
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(k.key for k in path): leaf for path, leaf in paths}


@pytest.mark.parametrize("clip", [False, True], ids=["clip_off", "clip_on"])
@pytest.mark.parametrize("master", [False, True], ids=["plain", "master"])
def test_adamw_update_matches_jax(clip, master):
    rng = np.random.default_rng(3)
    params = random_tree(rng)
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                           weight_decay=0.1, grad_clip=1.0)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    pdt = jnp.bfloat16 if master else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, pdt), params)
    jstate = jopt.init_opt_state(jp, master=master)
    tp = {n: torch.from_numpy(v).to(torch.bfloat16 if master
                                    else torch.float32, copy=True)
          for n, v in flat_jax_order(params).items()}
    tstate = topt.init_opt_state(tp, master=master)
    upd = compiled(lambda p, g, s: jopt.adamw_update(jcfg, p, g, s),
                   jp, jax.tree.map(lambda a: jnp.asarray(a), params), jstate)
    scale = 10.0 if clip else 0.01       # the gradients' scale
    for step in range(3):
        g = jax.tree.map(lambda a: (a * 0 + rng.standard_normal(a.shape)
                                    * scale).astype(np.float32), params)
        g["z"] = np.zeros_like(g["z"])    # the port gets None for it
        jp, jstate, jm = upd(jp, jax.tree.map(jnp.asarray, g), jstate)
        tg = {n: torch.from_numpy(v) for n, v in flat_jax_order(g).items()}
        tg["z"] = None
        _, tstate, tm = topt.adamw_update(cfg, tp, tg, tstate)
        assert (float(jm["grad_norm"]) > cfg.grad_clip) == clip
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL_LR)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        trees = [(tp, jp), (tstate["m"], jstate["m"]),
                 (tstate["v"], jstate["v"])]
        if master:
            trees.append((tstate["master"], jstate["master"]))
        for port, ref in trees:
            for name, want in flat_jax_order(ref).items():
                want = np.asarray(jnp.asarray(want, jnp.float32))
                got = port[name].float().numpy()
                tol = RTOL_UPDATE * max(np.abs(want).max(), 1e-30)
                if port is tp and master:
                    tol = max(tol, np.abs(want).max() * 2 ** -8)  # 1 ulp
                assert np.abs(got - want).max() <= tol, (step, name)
    # the leaf without a gradient took only the weight decay
    assert not torch.equal(tp["z"].float(),
                           torch.from_numpy(params["z"]).float())


def test_missing_gradient_steps_like_a_zero_one():
    """A ``None`` gradient is a zero gradient: the moments stay zero and
    the weight takes the decay alone, ``w - lr * (wd * w)``."""
    cfg = topt.AdamWConfig(lr=0.5, warmup_steps=0, total_steps=10,
                           weight_decay=0.1)
    w = torch.tensor([1.0, -2.0, 3.0])
    a = {"w": w.clone()}
    b = {"w": w.clone()}
    sa, sb = topt.init_opt_state(a), topt.init_opt_state(b)
    topt.adamw_update(cfg, a, {"w": None}, sa)
    topt.adamw_update(cfg, b, {"w": torch.zeros(3)}, sb)
    assert torch.equal(a["w"], b["w"])
    lr = topt.lr_schedule(cfg, torch.tensor(1))
    assert torch.equal(a["w"], w - lr * (cfg.weight_decay * w))
    assert not sa["m"]["w"].any() and not sa["v"]["w"].any()


# -- train steps ---------------------------------------------------------------


@pytest.fixture
def smoke_tinyllama():
    jcfg = jax_smoke_config("tinyllama_1_1b")
    jparams, _ = jax_build(jcfg).init(KEY)
    return jcfg, jparams


def pipeline_batches(tmp_path, vocab, n, batch, seq):
    """``n`` batches of the JAX package's pipeline over a synthetic
    corpus (the port's pipeline gives the same, tests/test_torch_data.py)."""
    master, client, _ = jax_make_sector(str(tmp_path / "sector"))
    jax_upload(client, "/corpus/t", jax_synthetic_tokens(60_000, vocab),
               num_slices=4)
    pipe = JaxPipeline(master, client, "/corpus/t", batch=batch, seq_len=seq)
    out = []
    while len(out) < n:
        for b in pipe:
            out.append(b)
            if len(out) == n:
                break
    return out


def run_both(jcfg, jparams, batches, accum_steps=1, lr=3e-3, warmup=5):
    """The same steps in both packages; returns (JAX losses, port
    losses, JAX params, port params, the lrs)."""
    opt_cfg = topt.AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=60)
    jmodel = jax_build(jcfg)
    jstep = jax_train_step(jmodel, jopt.AdamWConfig(
        **dataclasses.asdict(opt_cfg)), None, accum_steps=accum_steps)
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jstate = jopt.init_opt_state(jparams)
    jfn = compiled(jstep, jparams, jstate, jb0)

    cfg = get_smoke_config(jcfg.arch_id)
    model = build(cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                "cpu", dtype=torch.float32)
    tstate = topt.init_opt_state(named_leaves(tparams, cfg))
    tstep = build_train_step(model, opt_cfg, accum_steps=accum_steps)
    jl, tl, lrs = [], [], []
    jp = jparams
    for b in batches:
        jp, jstate, jm = jfn(jp, jstate, {k: jnp.asarray(v)
                                          for k, v in b.items()})
        _, tstate, tm = tstep(tparams, tstate,
                              {k: torch.from_numpy(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        lrs.append(float(tm["lr"]))
        assert set(tm) == set(jm)
    return np.array(jl), np.array(tl), jp, tparams, lrs


def assert_params_close(jp, tparams, lrs):
    want = flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    got = {n: p.detach().numpy() for n, p in tparams.named_parameters()}
    diffs = np.concatenate([np.abs(got[n] - want[n]).ravel() for n in want])
    assert diffs.max() <= 2 * sum(lrs)
    assert np.quantile(diffs, 0.99) <= 0.05 * sum(lrs)
    assert np.median(diffs) <= 0.005 * sum(lrs)


def test_five_train_steps_match_jax(tmp_path, smoke_tinyllama):
    jcfg, jparams = smoke_tinyllama
    batches = pipeline_batches(tmp_path, jcfg.vocab, 5, 8, 32)
    jl, tl, jp, tp, lrs = run_both(jcfg, jparams, batches)
    np.testing.assert_allclose(tl, jl, atol=ATOL_LOSS, rtol=0)
    assert_params_close(jp, tp, lrs)


def test_grad_accumulation_matches_jax_and_one_big_batch(tmp_path,
                                                         smoke_tinyllama):
    jcfg, jparams = smoke_tinyllama
    batches = pipeline_batches(tmp_path, jcfg.vocab, 1, 8, 16)
    jl, tl, jp, tp, lrs = run_both(jcfg, jparams, batches, accum_steps=2,
                                   lr=1e-3, warmup=0)
    np.testing.assert_allclose(tl, jl, atol=ATOL_LOSS, rtol=0)
    assert_params_close(jp, tp, lrs)
    # the same update as one big batch, up to the micro batches' loss
    # means (tests/test_train.py::test_grad_accumulation_matches_big_batch)
    _, _, _, big, _ = run_both(jcfg, jparams, batches, lr=1e-3, warmup=0)
    diff = max(float((a - b).detach().abs().max()) for a, b in
               zip(tp.parameters(), big.parameters()))
    assert diff < 5e-3


def test_launcher_smoke_on_the_cpu_loss_falls(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu``: the
    JAX launcher's lines, its checkpoints, and the loss falls as in
    tests/test_train.py::test_loss_decreases."""
    launch_train.main(["--smoke", "--device", "cpu", "--steps", "60",
                       "--batch", "8", "--seq", "32", "--ckpt-every", "25",
                       "--workdir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in out[:6]] == [
        ["step", str(s)] for s in (10, 20, 30, 40, 50, 60)]
    last = out[-1]
    assert last.startswith("final loss ") and "checkpoints: [25, 50, 60]" \
        in last
    final = float(last.split()[2])
    first = float(last.split("first10 ")[1].split(")")[0])
    assert np.isfinite([final, first]).all()
    assert final < first - 0.3
