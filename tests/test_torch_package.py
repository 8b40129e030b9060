"""Package rules of the port: no JAX, nothing of the JAX package, the card
by default, and no quiet fallback to the CPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.comm import Ranks, resolve_device
from repro_torch.core.sort import terasort
from repro_torch.kernels import bitonic_sort, bucket_hist, partition, radix_sort
from repro_torch.sphere.dataflow import SPMDExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_port_file_list_covers_the_slice():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES[:-1]}
    for want in ("comm.py", "interop.py", "kernels/partition.py",
                 "kernels/bitonic_sort.py", "kernels/radix_sort.py",
                 "kernels/bucket_hist.py", "kernels/build.py",
                 "core/shuffle.py", "core/sort.py", "core/mapreduce.py",
                 "core/stream.py", "core/udf.py", "core/introspect.py",
                 "sector/topology.py", "sphere/dataflow.py", "obs/trace.py",
                 "core/retry.py", "sector/security.py", "sector/slave.py",
                 "sector/transport.py", "sector/master.py",
                 "sector/client.py", "sphere/scheduler.py", "sphere/spe.py",
                 "sphere/engine.py", "launch/train.py", "sphere/chaos.py",
                 "sphere/streaming.py", "train/elastic.py",
                 "configs/base.py", "configs/qwen2_moe_a2_7b.py",
                 "models/layers.py", "models/attention.py", "models/moe.py",
                 "models/transformer.py", "models/registry.py",
                 "models/convert.py", "serve/engine.py", "launch/serve.py",
                 "models/ssm.py", "models/encdec.py", "train/optimizer.py",
                 "train/trainer.py", "train/checkpoint.py",
                 "data/synthetic.py", "data/pipeline.py", "data/__init__.py",
                 "launch/mesh.py", "launch/dryrun.py"):
        assert want in names
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert (csrc / "bucket_hist.cu").exists()
    for k in (partition.KERNEL, bitonic_sort.KERNEL, radix_sort.KERNEL,
              bucket_hist.KERNEL):
        assert (csrc / f"{k.name}.cu").exists(), k.name
        assert (ROOT / k.source).exists()


def test_entry_points_default_to_cuda(monkeypatch):
    if torch.cuda.is_available():
        assert Ranks().device.type == "cuda"
        assert Ranks(shape=(2, 4), axes=("dc", "node")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Ranks()
        with pytest.raises(RuntimeError, match="cuda"):
            Ranks(shape=(2, 4), axes=("dc", "node"))
    # without a card every default entry point refuses, never runs on CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu").type == "cpu"
    for call in (lambda: resolve_device(None), lambda: Ranks(),
                 lambda: Ranks(shape=(2, 4), axes=("dc", "node")),
                 lambda: SPMDExecutor(),
                 lambda: terasort(np.zeros((8, 4), np.int32),
                                  np.zeros((8, 4), np.int32))):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels = (partition.KERNEL, bitonic_sort.KERNEL, radix_sort.KERNEL,
               bucket_hist.KERNEL)
    before = [k.launches for k in kernels]
    d = torch.tensor([0, 1, 0, 5], dtype=torch.int32)
    partition.partition_rank(d, 2)
    bucket_hist.bucket_histogram(d, 2)
    k = torch.tensor([[3, 1, 2]], dtype=torch.int32)
    bitonic_sort.sort_kv_segments_bitonic(k, k)
    radix_sort.sort_kv_segments_radix(k, k)
    after = [k.launches for k in kernels]
    assert after == before


def test_other_devices_raise_instead_of_falling_back():
    d = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        partition.partition_rank(d, 2)
    k = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        radix_sort.sort_kv_segments_radix(k, k)
    with pytest.raises(ValueError, match="CUDA"):
        bitonic_sort.sort_segments_bitonic(k)


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if not torch.cuda.is_available():
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, str(script), "--n-log2", "12"],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    proc = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
