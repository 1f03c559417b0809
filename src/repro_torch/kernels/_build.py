"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each source is compiled on first use into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for ``sm_90a``.
Libraries land in ``csrc/build/`` (listed in ``.gitignore``) under a name
that carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header rebuilds. A source includes a
header by its plain name: nvcc looks beside the source first.
``build_all`` starts one nvcc per source at once and waits for all of them.
Each nvcc run and each library loaded counts as one kernel build in
``obs.cuda_watch`` (a trace span's ``compiles``).

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, Sequence

from ..obs import cuda_watch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("netes_mixing", "netes_sparse_mixing", "netes_fused_mixing",
           "flash_attention", "moe_router", "rwkv6_wkv", "mamba_scan",
           "pendulum_rollout")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> pathlib.Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    the headers beside it (``csrc/*.cuh``) and the flags."""
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def log_path(name: str) -> pathlib.Path:
    """nvcc's output (with ``-Xptxas -v``: registers, spills, shared
    memory per kernel) for the current build of ``name``."""
    return library_path(name).with_suffix(".log")


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, pathlib.Path]:
    """Compile every named source that has no current library, all at
    once; raise with nvcc's output if any compile fails."""
    names = list(names)
    jobs = []
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        with open(log_path(name), "w") as log:
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                 str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, target))
        cuda_watch.report_build(f"nvcc {name}")
    failed = []
    for name, proc, tmp, target in jobs:
        if proc.wait() == 0:
            os.replace(tmp, target)     # atomic: a library is whole or absent
        else:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log_path(name).read_text()}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: library_path(n) for n in names}


class CudaKernel:
    """One C entry point of a ``csrc/<source>.cu`` library.

    ``launches`` counts the launches made through ``launch``: one per call
    whose launch the CUDA runtime accepted, and nowhere else. The library
    is built and loaded at the first launch.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source, self.symbol, self.argtypes = source, symbol, argtypes
        self.launches = 0
        self._lib = self._fn = None

    def _load(self):
        path = build_all([self.source])[self.source]
        self._lib = ctypes.CDLL(str(path))
        cuda_watch.report_build(f"load {path.name}")
        fn = getattr(self._lib, self.symbol)
        fn.argtypes = list(self.argtypes)
        fn.restype = ctypes.c_int
        self._fn = fn

    def function(self, symbol: str, argtypes: Sequence):
        """Another C entry point of the same library (a query, not a
        launch: it counts nothing)."""
        if self._fn is None:
            self._load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        if self._fn is None:
            self._load()
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with "
                               f"cudaError_t {err}")
        self.launches += 1
