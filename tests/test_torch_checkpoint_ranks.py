"""Sector checkpoints saved by every process of a grid, in the JAX layout,
and restored onto another grid; the train launcher under ``torchrun``.
On the CPU.

One spawn of 4 gloo processes (``tests/torch_checkpoint_ranks_paths.py``,
no JAX; a hard ``timeout_s`` of its own) runs every case: 2 steps on
``(2, 2)`` ``("data", "model")``, the state saved from there with
``SectorCheckpointer.save(..., ranks=, specs=)`` into one Sector
deployment the processes share, restored onto ``(4, 1)`` built over the
same processes, saved again, one step on ``(4, 1)``, and two planted
faults. The cases are ``test_torch_checkpoint.py``'s layouts: smoke
TinyLlama with ``tp_size=2`` (the heads layout; stacked blocks), smoke
zamba2 (listed blocks) and smoke whisper (two stacked collections) with
bfloat16 parameters and the float32 master copy. The weights are the
JAX package's ``init`` at ``PRNGKey(0)``; the batches consecutive blocks
of the corpus (whisper's with stub frames and a ``loss_mask``).

Exact: the processes' checkpoint is the one-process port's save of the
gathered state (every slice byte, MD5 and the manifest), the JAX
package's ``restore`` reads it to the same leaves, every process's
view of Sector indexes what a scan of the slaves finds, the blocks
restored onto ``(4, 1)`` are its specs' cut of those leaves, and a
re-save from ``(4, 1)`` repeats every MD5. Bounded
(``tests/test_torch_train_dist.py``'s): the step on ``(4, 1)`` from the
restored state against the one process's step from the gathered state,
loss within 2e-3, ``grad_norm`` within 5e-3 relative, the parameters
(the master copy where there is one) by the trainer tests' rule. The
planted faults must fail: a slice corrupted on every copy raises on
all 4 processes well inside the limit, and the old grid's blocks saved
from the new grid do not repeat the MD5s.

TinyLlama's state is saved and restored once more on a grid kept to
NCCL's rule (the launcher's default backend carries no host tensor):
every host byte, object and barrier must take the grid's gloo group.
The one-process async save is held beside the daemon's passes, and two
threads replicating one file write one copy.

The launcher runs under real ``torchrun`` (4 gloo processes on ``(2,
2)``, 4 steps, checkpoints at 2 and 4, a loss line every step) against
the one-process ``train()`` at the same settings, step by step.
"""

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.train import make_sector as jax_make_sector
from repro.models import build as jax_build
from repro.train.checkpoint import SectorCheckpointer as JaxCheckpointer
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.comm import shard_slices, spawn_ranks
from repro_torch.configs.base import get_smoke_config
from repro_torch.data import synthetic_tokens
from repro_torch.launch.train import make_sector, train
from repro_torch.models import build
from repro_torch.models.convert import (Stacked, flatten, named_leaves,
                                        unflatten)
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import SectorCheckpointer, _leaves
from repro_torch.train.trainer import (build_train_step, load_state_tree,
                                       state_tree)
import torch_checkpoint_ranks_paths as paths
import torch_train_dist_encdec_paths as epaths

HERE = os.path.dirname(os.path.abspath(__file__))
GRID, AXES = (2, 2), ("data", "model")
STEPS, BATCH, SEQ, SEED = 3, 8, 32, 0
OPT = topt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
ATOL_LOSS = 2e-3
RTOL_GNORM = 5e-3
#: the trainer tests' rule: the max, the 99th percentile and the median
#: of the parameters' differences, over ``sum(lr)``
RULE = np.array([2.0, 0.05, 0.005])
TIMEOUT_S = 240
#: a corrupted slice must raise on every process within this
CORRUPT_S = 30
#: case: (arch, tp_size or None, bfloat16 parameters and the master copy)
CASES = {"tinyllama": ("tinyllama_1_1b", 2, False),
         "zamba2": ("zamba2_1_2b", None, False),
         "whisper_master": ("whisper_small", None, True)}
LAUNCH = dict(steps=4, batch=8, seq=128, ckpt_every=2, data=2, model=2)


def _configs(arch, tp):
    import dataclasses
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    if tp is not None:
        cfg = dataclasses.replace(cfg, tp_size=tp)
        jcfg = dataclasses.replace(jcfg, tp_size=tp)
    return cfg, jcfg


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, (arch, tp, master) in CASES.items():
        cfg, jcfg = _configs(arch, tp)
        jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
        toks = synthetic_tokens(STEPS * BATCH * (SEQ + 1), cfg.vocab)
        batches = epaths.train_batches(
            np.random.default_rng(SEED),
            toks.reshape(STEPS, BATCH, SEQ + 1), cfg, GRID[0])
        out[name] = {"cfg": cfg, "jcfg": jcfg, "jparams": jparams,
                     "master": master, "batches": batches,
                     "flat": flatten(jax.tree.map(np.asarray, jparams))}
    return out


@pytest.fixture(scope="module")
def spawned(cases, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt_ranks"))
    # weights as tensors: spawn hands tensors over in shared memory
    inputs = {name: {"cfg": c["cfg"], "master": c["master"],
                     "batches": c["batches"],
                     "flat": {n: torch.from_numpy(np.array(v))
                              for n, v in c["flat"].items()}}
              for name, c in cases.items()}
    t0 = time.perf_counter()
    results = spawn_ranks(paths.run_cases, GRID, AXES, device="cpu",
                          timeout_s=TIMEOUT_S, args=(inputs, OPT, root))
    return results, root, time.perf_counter() - t0


def _state_tree(c, flat: dict):
    """The gathered state (``params.<name>``, ``m.<name>``, ...) as
    ``state_tree`` lays it out."""
    cfg = c["cfg"]
    groups = {}
    for key, t in flat.items():
        if key == "step":
            continue
        head, name = key.split(".", 1)
        groups.setdefault(head, {})[name] = t
    opt = {k: unflatten(v, cfg) for k, v in groups.items() if k != "params"}
    opt["step"] = flat["step"]
    return {"params": unflatten(groups["params"], cfg), "opt": opt}


def _slices(client, step):
    m = json.loads(client.download(
        f"{paths.PREFIX}/step_{step:08d}/MANIFEST.json"))
    return m, [client.download(s["path"]) for s in m["slices"]]


@pytest.fixture(scope="module")
def one_process(spawned, cases, tmp_path_factory):
    """The one-process port's save of each case's gathered state, and the
    processes' checkpoint read back through a view of their slaves."""
    results, root, _ = spawned
    out = {}
    for name, c in cases.items():
        tree = _state_tree(c, results[0][name]["state"])
        _, client, _ = make_sector(str(tmp_path_factory.mktemp(name)))
        SectorCheckpointer(client, paths.PREFIX, num_slices=4).save(2, tree)
        _, theirs, _ = make_sector(os.path.join(root, name))
        out[name] = {"tree": tree, "mine": _slices(client, 2),
                     "theirs": _slices(theirs, 2), "client": theirs}
    return out


# -- the save: the one-process checkpoint, byte for byte ---------------------


@pytest.mark.parametrize("case", list(CASES))
def test_process_save_is_the_one_process_save(one_process, case):
    (pm, pbytes), (qm, qbytes) = (one_process[case]["theirs"],
                                  one_process[case]["mine"])
    assert len(pbytes) == 4
    assert pbytes == qbytes
    assert pm == qm


@pytest.mark.parametrize("case", list(CASES))
def test_jax_package_restores_the_process_checkpoint(one_process, cases,
                                                     tmp_path, case):
    c = cases[case]
    client = one_process[case]["client"]
    _, jclient, _ = jax_make_sector(str(tmp_path / "jax"))
    for fm in client.ls(f"{paths.PREFIX}/step_{2:08d}/"):
        jclient.upload(fm.path, client.download(fm.path))
    like = {"params": c["jparams"],
            "opt": jax_init_opt_state(c["jparams"], master=c["master"])}
    back, step = JaxCheckpointer(jclient, paths.PREFIX).restore(like)
    assert step == 2
    want = [torch.stack(list(leaf)) if isinstance(leaf, Stacked) else leaf
            for leaf in _leaves(one_process[case]["tree"])]
    got = jax.tree.leaves(back)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = np.asarray(a)
        assert list(a.shape) == list(b.shape)
        assert a.tobytes() == b.contiguous().reshape(-1).view(torch.uint8) \
            .numpy().tobytes()


@pytest.mark.parametrize("case", list(CASES))
def test_every_view_indexes_what_a_scan_finds(spawned, case):
    """Each process's master view of the checkpoint's files (learned from
    the processes that wrote them) equals a scan of the slaves."""
    results, root, _ = spawned
    master, _, _ = make_sector(os.path.join(root, case))
    master.recover_from_scan()
    # the re-save and the planted faults came later: step 2's files
    step2 = f"{paths.PREFIX}/step_{2:08d}/"
    scan = {p: (m.size, m.md5, sorted(m.locations))
            for p, m in master.index.items() if p.startswith(step2)}
    assert len(scan) == 5
    for r in results:
        view = {p: v for p, v in r[case]["index"].items()
                if p.startswith(step2)}
        assert view == scan, r["rank"]
    assert all(len(v[2]) == 2 for v in scan.values())   # replication 2


# -- the restore onto (4, 1) ------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_restored_blocks_are_the_new_grids_cut(spawned, case):
    results, _, _ = spawned
    full = results[0][case]["state"]
    p_specs, opt_specs = results[0][case]["new_specs"]
    specs = {"params": p_specs, **opt_specs}
    for rank, r in enumerate(results):
        got = r[case]["restored"]
        assert r[case]["restored_step"] == 2
        assert set(got) == set(full)
        for key, want in full.items():
            if key == "step":
                assert torch.equal(got[key], want)
                continue
            head, name = key.split(".", 1)
            block = want[shard_slices(want.shape, specs[head][name],
                                      paths.NEW_GRID, AXES, rank)]
            assert got[key].dtype == want.dtype, key
            assert torch.equal(got[key], block), (rank, key)


@pytest.mark.parametrize("case", list(CASES))
def test_resave_from_the_new_grid_repeats_every_md5(spawned, case):
    results, _, _ = spawned
    first, again = results[0][case]["manifest"], results[0][case]["resave"]
    assert [s["md5"] for s in again["slices"]] == \
        [s["md5"] for s in first["slices"]]
    assert [s["nbytes"] for s in again["slices"]] == \
        [s["nbytes"] for s in first["slices"]]
    assert again["leaves"] == first["leaves"]
    assert again["step"] == 3 and first["step"] == 2


@pytest.mark.parametrize("case", list(CASES))
def test_step_on_the_new_grid_matches_one_process(spawned, one_process,
                                                  cases, case):
    """The next step on ``(4, 1)`` from the restored state against the
    one process's step from the gathered state."""
    results, _, _ = spawned
    c = cases[case]
    cfg, master = c["cfg"], c["master"]
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu",
                        dtype=torch.float32)
    opt = topt.init_opt_state(named_leaves(params, cfg), master)
    if master:
        params.trainable(torch.bfloat16)
    load_state_tree(model, params, opt, one_process[case]["tree"])
    _, _, m = build_train_step(model, OPT)(
        params, opt, {k: torch.from_numpy(v)
                      for k, v in c["batches"][2].items()})
    got = results[0][case]["new_step"]
    assert all(r[case]["new_step"] == got for r in results)
    assert abs(got["loss"] - float(m["loss"])) <= ATOL_LOSS
    assert abs(got["grad_norm"] - float(m["grad_norm"])) <= \
        RTOL_GNORM * float(m["grad_norm"])
    assert got["lr"] == float(m["lr"])
    after = results[0][case]["after"]
    key = "master" if master else "params"
    want = (opt["master"] if master else
            {n: p.detach() for n, p in named_leaves(params, cfg).items()})
    d = torch.cat([(after[f"{key}.{n}"].float() - w.float()).abs()
                   .reshape(-1) for n, w in want.items()])
    reading = np.array([float(d.max()), float(torch.quantile(d, 0.99)),
                        float(d.median())]) / got["lr"]
    assert (reading <= RULE).all(), reading
    if master:
        for n in want:
            assert torch.equal(after[f"params.{n}"],
                               after[f"master.{n}"].bfloat16()), n


# -- the planted faults ------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_corrupt_slice_raises_on_every_process(spawned, case):
    results, _, _ = spawned
    for r in results:
        assert "checksum mismatch" in r[case]["corrupt"], r["rank"]
        assert "slice.00001" in r[case]["corrupt"]
        assert r[case]["corrupt_s"] < CORRUPT_S


@pytest.mark.parametrize("case", list(CASES))
def test_old_grid_cut_fails_the_md5_equality(spawned, case):
    """The blocks the old grid's specs cut, saved as the new grid's, do
    not give the checkpoint back: the planted fault the MD5 equality
    must see."""
    results, _, _ = spawned
    first = results[0][case]["manifest"]
    for r in results:
        old = r[case]["old_cut"]
        assert isinstance(old, dict), old
        assert [s["md5"] for s in old["slices"]] != \
            [s["md5"] for s in first["slices"]]


def test_checkpoint_traffic_takes_the_host_group_beside_nccl(spawned):
    """The launcher's default backend is NCCL, which carries no host
    tensor: on a grid kept to NCCL's rule (``paths.nccl_rule``) a save
    and a restore send every byte, object and barrier over the grid's
    gloo host group, give the first checkpoint's MD5s and each process
    its own blocks back; the rule refuses host bytes on the device
    backend's groups."""
    results, _, _ = spawned
    first = results[0]["tinyllama"]["manifest"]
    for r in results:
        got = r["tinyllama"]["nccl_rule"]
        assert got["md5s"] == [s["md5"] for s in first["slices"]]
        assert got["restored_equal"], r["rank"]
        assert got["refused"] == ["ValueError", "RuntimeError"]


def test_spawn_is_inside_its_limit(spawned):
    _, _, seconds = spawned
    assert seconds < TIMEOUT_S


# -- the one-process async save beside the daemon ----------------------------


def test_async_save_beside_daemon_ticks(tmp_path):
    """The launcher's one-process async save: the upload threads write and
    replicate the slices while the loop's ``daemon.tick()`` walks the
    index, here without a pause. Every file ends with exactly the
    replication factor of copies, each copy's bytes with the index's
    MD5, and the last checkpoint restores to the bit."""
    import hashlib
    master, client, daemon = make_sector(str(tmp_path))
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(1 << 20, generator=gen),
            "b": [torch.randn(7, generator=gen) for _ in range(3)]}
    ckpt = SectorCheckpointer(client, "/ckpt", num_slices=16)
    ticks = 0
    for step in (1, 2):
        ckpt.save(step, tree, blocking=False)
        while ckpt._thread is not None and ckpt._thread.is_alive():
            daemon.tick()
            ticks += 1
        ckpt.wait()
    daemon.run_until_stable()
    files = client.ls("/ckpt/")
    assert ticks and len(files) == 2 * 17
    for fm in files:
        assert len(fm.locations) == master.replication_factor, fm.path
        for sid in fm.locations:
            data = master.slaves[sid].read_file(fm.path)
            assert hashlib.md5(data).hexdigest() == fm.md5, (fm.path, sid)
    back, step = ckpt.restore(tree)
    assert step == 2 and torch.equal(back["w"], tree["w"])
    assert all(torch.equal(a, b) for a, b in zip(back["b"], tree["b"]))


def test_one_copy_when_two_threads_replicate_a_file(tmp_path, monkeypatch):
    """Two threads bring one file to the replication factor at once (a
    checkpoint's upload thread and the daemon's pass): one copy is
    written, by one of them."""
    from repro_torch.sector.slave import SlaveNode
    master, client, _ = make_sector(str(tmp_path))
    client.upload("/f", b"x" * 1000)
    write = SlaveNode.write_file

    def slow(self, path, data):
        time.sleep(0.2)
        return write(self, path, data)

    monkeypatch.setattr(SlaveNode, "write_file", slow)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        made = list(pool.map(lambda _: master.replicate("/f"), range(2)))
    assert sorted(made) == [0, 1]
    assert len(master.lookup("/f").locations) == 2
    assert master.stats["replications"] == 1


# -- the launcher under torchrun ---------------------------------------------


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """``torchrun`` with 4 gloo processes, and the one-process ``train()``
    at the same settings meanwhile."""
    work = str(tmp_path_factory.mktemp("torchrun"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--smoke", "--device", "cpu", "--data", "2", "--model", "2",
           "--backend", "gloo", "--steps", "4", "--ckpt-every", "2",
           "--log-every", "1", "--workdir", work]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(proc.communicate, timeout=TIMEOUT_S)
        one = train(get_smoke_config("tinyllama_1_1b"), device="cpu",
                    workdir=str(tmp_path_factory.mktemp("one")),
                    log=lambda line: None, **LAUNCH)
        out, err = job.result()
    return {"rc": proc.returncode, "out": out, "err": err, "work": work,
            "one": one, "seconds": time.perf_counter() - t0}


def _step_losses(out: str) -> dict:
    """``{step: loss}`` of the launcher's ``step N loss X`` lines; a step
    printed twice fails."""
    got = {}
    for m in re.finditer(r"^step\s+(\d+) loss ([-\d.]+) ", out, re.M):
        assert int(m.group(1)) not in got, out
        got[int(m.group(1))] = float(m.group(2))
    return got


def test_torchrun_launcher_runs_and_prints_once(launched):
    assert launched["rc"] == 0, launched["err"][-3000:]
    finals = [l for l in launched["out"].splitlines()
              if l.startswith("final loss")]
    assert len(finals) == 1, launched["out"]
    assert finals[0].endswith("checkpoints: [2, 4]")
    assert sorted(_step_losses(launched["out"])) == [1, 2, 3, 4]
    assert launched["seconds"] < TIMEOUT_S


def test_torchrun_losses_match_one_process(launched):
    """Each step's loss (``--log-every 1``, printed to 4 decimals) and the
    final line's means against the one-process ``train()``'s."""
    want = launched["one"]["losses"]
    got = _step_losses(launched["out"])
    assert sorted(got) == list(range(1, len(want) + 1))
    for step, loss in got.items():
        assert abs(loss - want[step - 1]) <= ATOL_LOSS, (step, loss)
    line = [l for l in launched["out"].splitlines()
            if l.startswith("final loss")][0]
    final, first = map(float, re.match(
        r"final loss ([-\d.]+) \(first10 ([-\d.]+)\)", line).groups())
    assert abs(final - float(np.mean(want[-10:]))) <= ATOL_LOSS
    assert abs(first - float(np.mean(want[:10]))) <= ATOL_LOSS


@pytest.mark.parametrize("step", [2, 4])
def test_torchrun_checkpoints_hold_the_one_process_state(launched, step):
    """Each checkpoint of the 4 processes, restored whole, against the
    one process's at the same step: the leaf table equal, the step
    equal, the parameters by the trainer tests' rule."""
    one = launched["one"]
    _, client, _ = make_sector(launched["work"])
    like = state_tree(one["model"], one["params"], one["opt"])
    got, s = SectorCheckpointer(client, "/ckpt/run0").restore(like, step)
    want, _ = one["ckpt"].restore(like, step)
    assert s == step
    pm = json.loads(client.download(f"/ckpt/run0/step_{step:08d}/"
                                    "MANIFEST.json"))
    qm = json.loads(one["client"].download(f"/ckpt/run0/step_{step:08d}/"
                                           "MANIFEST.json"))
    assert pm["leaves"] == qm["leaves"] and pm["treedef"] == qm["treedef"]
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == step
    lrs = [m["lr"] for m in one["metrics"][:step]]
    d = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(
        flatten(got["params"]).values(), flatten(want["params"]).values())])
    reading = np.array([float(d.max()), float(torch.quantile(d, 0.99)),
                        float(d.median())]) / sum(lrs)
    assert (reading <= RULE).all(), reading
