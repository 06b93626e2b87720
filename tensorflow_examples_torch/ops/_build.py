"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`. Libraries
live in ``build/torch_kernels/`` at the checkout root (``build/`` is
git-ignored), named by a hash of the source, of every ``csrc`` header it
includes and of the compiler flags, so an edited kernel or header rebuilds
and an unchanged one is reused. Nothing is built
at import: the first kernel launch builds every missing library, one
``nvcc`` process per source, all started together. The CPU tests never
get here, because a wrapper only launches a kernel for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("decode", "paged_decode", "flash_attention", "cross_entropy", "grouped_matmul")
# -Xptxas=-v prints registers, shared memory and spills per kernel into
# the build log; it does not change the binary.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> nvcc's output for the libraries this process built.
build_logs: dict[str, str] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA "
            "kernels are built from ops/csrc at first use and need the "
            "CUDA toolkit"
        )
    return path


def _local_headers(src: bytes) -> list[str]:
    """The ``csrc`` headers that a source (or header) includes by
    ``#include "name"``, followed through nested includes, sorted."""
    seen: set[str] = set()
    todo = [src]
    while todo:
        for name in re.findall(rb'^\s*#\s*include\s*"([^"]+)"', todo.pop(), re.M):
            header = name.decode()
            if header not in seen:
                seen.add(header)
                todo.append((CSRC / header).read_bytes())
    return sorted(seen)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    parts = [src] + [(CSRC / h).read_bytes() for h in _local_headers(src)]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all() -> float:
    """Build every library that is missing, all ``nvcc`` processes at
    once; returns the wall seconds spent (0.0 when all were present).
    Raises with nvcc's output when any build fails."""
    with _lock:
        pending = [n for n in SOURCES if not library_path(n).exists()]
        if not pending:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
        t0 = time.perf_counter()
        procs = []
        for name in pending:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for name, tmp, out, proc in procs:
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode:
                failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``ops/csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def check(status: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if status:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
