"""Build the Hopper kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so

The build happens at first use, into ``build/kernels/`` at the root of the
checkout (``.gitignore`` lists ``build/``); the file name carries a hash of
the sources and flags, so an edited kernel is never served from a stale
library. :func:`build_all` starts one ``nvcc`` per source at once.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p``, launches on that stream, never synchronises, and returns
``cudaGetLastError()``; :meth:`Kernel.launch` raises when it is not 0.
Nothing here runs at import time.

A process that runs with ``REPRO_KERNELS_PREBUILT=1`` in its environment
(every rank :func:`repro_torch.comm.spawn_ranks` starts) never runs
``nvcc``: it loads the libraries its parent built and raises when one is
missing, so that ranks never race one another on ``build/kernels/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: <checkout>/build/kernels (this file is <checkout>/src/repro_torch/kernels/)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()

#: every kernel source under ``csrc/``, K1, K3, K2, K4
KERNEL_NAMES = ("partition", "bitonic_sort", "radix_sort", "bucket_hist")
#: set to 1: load the parent's libraries, never build (see the docstring)
PREBUILT_ENV = "REPRO_KERNELS_PREBUILT"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "Hopper kernels are built from source at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


class BuildResult:
    """One finished ``nvcc`` run: seconds and its ``-Xptxas -v`` lines."""

    def __init__(self, name: str, seconds: float, log: str):
        self.name = name
        self.seconds = seconds
        self.ptxas = [ln.strip() for ln in log.splitlines()
                      if "ptxas info" in ln and ("Used" in ln
                                                 or "Compiling" in ln)]


def _start(name: str):
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Sequence[str]) -> Dict[str, BuildResult]:
    """Build every named source that has no current library, all at once
    (one ``nvcc`` process each). Raises if any build fails."""
    results: Dict[str, BuildResult] = {}
    running = []
    t0 = time.perf_counter()
    with _lock:
        missing = [n for n in names if not library_path(n).exists()]
        if missing and os.environ.get(PREBUILT_ENV) == "1":
            raise RuntimeError(
                f"kernels {missing} are not built, and this process may not "
                f"build them ({PREBUILT_ENV}=1): build them before starting "
                f"the ranks")
        for name in names:
            if library_path(name).exists():
                results[name] = BuildResult(name, 0.0, "")
            else:
                running.append((name,) + _start(name))
        failures = []
        for name, proc, tmp, out in running:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc {name}.cu failed "
                                f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            results[name] = BuildResult(name, time.perf_counter() - t0, log)
        if failures:
            raise RuntimeError("\n".join(failures))
    return results


class Kernel:
    """A hand-written CUDA kernel: its library, its C entry points and the
    launch counter its wrapper keeps.

    ``launches`` counts wrapper calls that launched the kernel on the card
    (one per call, however many CUDA launches the call issues); calls that
    took the plain version for a CPU tensor do not count.
    """

    def __init__(self, name: str, replaces: str):
        self.name = name
        self.replaces = replaces
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        self._fns: Dict[str, ctypes._CFuncPtr] = {}

    @property
    def source(self) -> str:
        return f"src/repro_torch/kernels/csrc/{self.name}.cu"

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build_all([self.name])
            lib = ctypes.CDLL(str(library_path(self.name)))
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            self._lib = lib
        return self._lib

    def _fn(self, symbol: str):
        fn = self._fns.get(symbol)
        if fn is None:
            fn = getattr(self.lib(), symbol)
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
        return fn

    def launch(self, symbol: str, *args) -> None:
        """Call C entry point ``symbol``; ints go as ``c_longlong``, pointers
        (tensors) and the current stream as ``c_void_p``. Raises on a
        non-zero ``cudaGetLastError()``."""
        cargs: List = []
        device = None
        for a in args:
            if isinstance(a, torch.Tensor):
                device = a.device
                cargs.append(ctypes.c_void_p(a.data_ptr()))
            elif a is None:
                cargs.append(ctypes.c_void_p(0))
            else:
                cargs.append(ctypes.c_longlong(int(a)))
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            cargs.append(ctypes.c_void_p(stream))
            rc = self._fn(symbol)(*cargs)
        if rc != 0:
            msg = self.lib().kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.name}:{symbol} launch failed: "
                               f"CUDA error {rc} ({msg})")
        self.launches += 1


def require_cuda(*tensors: torch.Tensor) -> None:
    """The kernels take CUDA tensors only (CPU tensors go to the plain
    versions before this is reached); anything else raises."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"kernel needs a CUDA tensor, got {t.device}")
    devs = {t.device for t in tensors}
    if len(devs) > 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
