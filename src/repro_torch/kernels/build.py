"""Build and load the port's CUDA kernels (``repro_torch/csrc``).

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links the objects into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library goes to ``build/`` at the repository root, named by a hash of the
sources and flags: an edited kernel rebuilds, an unchanged one loads at
once.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output of the build this process ran (ptxas -v)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with "
            "the CUDA toolkit")
    return path


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    global build_log
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    work = BUILD_DIR / f"work-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        objs = [work / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = work / target.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, target)  # atomic: concurrent builders race safely
    finally:
        shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source set has no
    library in ``build/`` yet."""
    global _lib
    with _lock:
        if _lib is None:
            target = _library_path()
            if not target.exists():
                _build(target)
            _lib = ctypes.CDLL(str(target))
        return _lib


def entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types declared;
    every entry point returns a CUDA error code."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
