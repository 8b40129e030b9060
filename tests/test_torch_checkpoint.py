"""The port's Sector checkpoints against the JAX package's, on the CPU.

The checkpoint tests of ``tests/test_train.py`` (roundtrip, MD5 mismatch,
slave loss, async save, garbage collection) on the port's
``SectorCheckpointer``, and the two packages' checkpoints held to each
other: for the same train state both write the same slices (the same
MD5s, byte for byte), and each restores the other's. Each package runs
its own ``make_sector`` deployment under ``tmp_path``. The state is the
JAX package's smoke model at ``PRNGKey(0)`` with AdamW's state, carried
into the port in float32 (exact), so every comparison is exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.train import make_sector as jax_make_sector
from repro.models import build as jax_build
from repro.train.checkpoint import SectorCheckpointer as JaxCheckpointer
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import make_sector
from repro_torch.models import build
from repro_torch.models.convert import (Stacked, flatten, named_leaves,
                                        opt_state_from_numpy,
                                        params_from_numpy, unflatten)
from repro_torch.train.checkpoint import SectorCheckpointer
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.trainer import load_state_tree, state_tree

KEY = jax.random.PRNGKey(0)


@pytest.fixture
def sectors(tmp_path):
    """(port: master, client, daemon), (JAX: master, client, daemon)."""
    return (make_sector(str(tmp_path / "port")),
            jax_make_sector(str(tmp_path / "jax")))


def jax_state(arch="tinyllama_1_1b", step=7):
    """The JAX package's train state, with non-zero moments and step."""
    cfg = jax_smoke_config(arch)
    params, _ = jax_build(cfg).init(KEY)
    opt = jax_init_opt_state(params)
    rng = np.random.default_rng(5)
    opt = {"m": jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), opt["m"]),
        "v": jax.tree.map(lambda a: jnp.asarray(
            rng.random(a.shape), jnp.float32), opt["v"]),
        "step": jnp.asarray(step, jnp.int32)}
    return {"params": params, "opt": opt}


def port_state(tree, arch="tinyllama_1_1b"):
    """The same state in the port: (model bundle, params, opt)."""
    cfg = get_smoke_config(arch)
    np_tree = jax.tree.map(np.asarray, tree)
    params = params_from_numpy(np_tree["params"], cfg, "cpu",
                               dtype=torch.float32)
    return build(cfg), params, opt_state_from_numpy(np_tree["opt"], cfg,
                                                    "cpu")


def slice_md5s(client, prefix, step):
    return [(fm.path, fm.md5) for fm in
            sorted(client.ls(f"{prefix}/step_{step:08d}/"),
                   key=lambda fm: fm.path) if "slice" in fm.path]


def assert_states_equal(model, params, opt, params2, opt2):
    a = named_leaves(params, model.cfg)
    b = named_leaves(params2, model.cfg)
    assert list(a) == list(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n
    for k in ("m", "v"):
        assert list(opt[k]) == list(opt2[k])
        for n in opt[k]:
            assert torch.equal(opt[k][n], opt2[k][n]), (k, n)
    assert int(opt["step"]) == int(opt2["step"])


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "zamba2_1_2b",
                                  "whisper_small"])
def test_both_packages_write_the_same_slices(sectors, arch):
    """Stacked (tinyllama, whisper's two collections) and listed (zamba2)
    blocks: the port's leaves, offsets and slices are the JAX
    package's, byte for byte."""
    (_, client, _), (_, jclient, _) = sectors
    tree = jax_state(arch)
    model, params, opt = port_state(tree, arch)
    JaxCheckpointer(jclient, "/ckpt/j", num_slices=4).save(7, tree)
    SectorCheckpointer(client, "/ckpt/p", num_slices=4).save(
        7, state_tree(model, params, opt))
    want = slice_md5s(jclient, "/ckpt/j", 7)
    got = slice_md5s(client, "/ckpt/p", 7)
    assert len(got) == 4
    assert [m for _, m in got] == [m for _, m in want]
    for (p, _), (q, _) in zip(got, want):
        assert client.download(p) == jclient.download(q)
    pm = json.loads(client.download("/ckpt/p/step_00000007/MANIFEST.json"))
    jm = json.loads(jclient.download("/ckpt/j/step_00000007/MANIFEST.json"))
    for k in ("leaves", "step", "total_bytes", "slices"):
        if k == "slices":
            assert [s["md5"] for s in pm[k]] == [s["md5"] for s in jm[k]]
        else:
            assert pm[k] == jm[k], k


def test_jax_checkpoint_restores_into_the_port_and_back(sectors):
    (_, client, _), (_, jclient, _) = sectors
    tree = jax_state()
    JaxCheckpointer(jclient, "/ckpt/j", num_slices=3).save(7, tree)
    # the JAX package's slices, copied into the port's Sector as they are
    for fm in jclient.ls("/ckpt/j/"):
        client.upload(fm.path, jclient.download(fm.path))
    model, params, opt = port_state(tree)
    fresh = model.init(torch.Generator().manual_seed(1), "cpu",
                       dtype=torch.float32)
    fresh_opt = init_opt_state(named_leaves(fresh, model.cfg))
    restored, step = SectorCheckpointer(client, "/ckpt/j").restore(
        state_tree(model, fresh, fresh_opt))
    assert step == 7
    load_state_tree(model, fresh, fresh_opt, restored)
    assert_states_equal(model, params, opt, fresh, fresh_opt)

    # and the port's checkpoint into the JAX package
    SectorCheckpointer(client, "/ckpt/p", num_slices=3).save(
        9, state_tree(model, params, opt))
    for fm in client.ls("/ckpt/p/"):
        jclient.upload(fm.path, client.download(fm.path))
    back, step = JaxCheckpointer(jclient, "/ckpt/p").restore(tree)
    assert step == 9
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bfloat16_leaves_are_raw_words(sectors):
    """The master variant's bfloat16 parameters: dtype "bfloat16", the
    raw 2-byte words (the JAX package's bytes), read back by torch
    without numpy's bfloat16."""
    (_, client, _), (_, jclient, _) = sectors
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    odd = rng.standard_normal(7).astype(np.float32)      # 14 bytes: unaligned
    jtree = {"a": jnp.asarray(odd, jnp.bfloat16), "b": jnp.asarray(w),
             "step": jnp.asarray(3, jnp.int32)}
    ttree = {"a": torch.from_numpy(odd).bfloat16(), "b": torch.from_numpy(w),
             "step": torch.tensor(3, dtype=torch.int32)}
    JaxCheckpointer(jclient, "/c", num_slices=2).save(1, jtree)
    ck = SectorCheckpointer(client, "/c", num_slices=2)
    ck.save(1, ttree)
    assert slice_md5s(client, "/c", 1) == slice_md5s(jclient, "/c", 1)
    meta = json.loads(client.download("/c/step_00000001/MANIFEST.json"))
    assert [m["dtype"] for m in meta["leaves"]] == ["bfloat16", "float32",
                                                    "int32"]
    back, _ = ck.restore(ttree)
    for k in ttree:
        assert back[k].dtype == ttree[k].dtype
        assert torch.equal(back[k], ttree[k]), k


# -- tests/test_train.py's checkpoint tests on the port -------------------------------


@pytest.fixture
def state():
    model, params, opt = port_state(jax_state())
    return model, params, opt


def test_checkpoint_roundtrip_and_md5(sectors, state):
    (m, c, daemon), _ = sectors
    model, params, opt = state
    ck = SectorCheckpointer(c, "/ckpt/t", num_slices=4)
    tree = state_tree(model, params, opt)
    ck.save(10, tree)
    daemon.run_until_stable()
    restored, step = ck.restore(tree)
    assert step == 10
    assert isinstance(restored["params"]["blocks"]["attn"]["wq"], Stacked)
    for a, b in zip(flatten(tree["params"]).values(),
                    flatten(restored["params"]).values()):
        assert torch.equal(a, b)
    # a corrupted slice is refused
    path = "/ckpt/t/step_00000010/slice.00001"
    for sid in m.lookup(path).locations:
        with open(m.slaves[sid]._local(path), "r+b") as f:
            f.write(b"\xff\xfe")
    with pytest.raises(IOError, match="checksum"):
        ck.restore(tree)


def test_checkpoint_survives_slave_loss(sectors, state):
    (m, c, daemon), _ = sectors
    model, params, opt = state
    ck = SectorCheckpointer(c, "/ckpt/t", num_slices=4)
    tree = unflatten(named_leaves(params, model.cfg), model.cfg)
    ck.save(5, tree)
    daemon.run_until_stable()      # replication factor 2 reached
    slice_path = "/ckpt/t/step_00000005/slice.00000"
    victim = next(iter(m.lookup(slice_path).locations))
    m.slaves[victim].kill(wipe=True)
    restored, step = ck.restore(tree)
    for a, b in zip(flatten(tree).values(), flatten(restored).values()):
        assert torch.equal(a, b)


def test_async_checkpoint(sectors, state):
    (m, c, daemon), _ = sectors
    model, params, opt = state
    ck = SectorCheckpointer(c, "/ckpt/a", num_slices=2)
    tree = state_tree(model, params, opt)
    ck.save(1, tree, blocking=False)
    # the state was copied before save returned: changing it now does not
    # change the checkpoint
    name, first = next(iter(named_leaves(params, model.cfg).items()))
    before = first.detach().clone()
    with torch.no_grad():
        first.add_(1.0)
    ck.wait()
    assert ck.list_steps() == [1]
    restored, _ = ck.restore(tree)
    assert torch.equal(flatten(restored["params"])[name], before)


def test_checkpoint_gc_keeps_last(sectors, state):
    (m, c, daemon), _ = sectors
    model, params, opt = state
    ck = SectorCheckpointer(c, "/ckpt/g", num_slices=2, keep=2)
    tree = unflatten(named_leaves(params, model.cfg), model.cfg)
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    assert ck.list_steps() == [3, 4]
