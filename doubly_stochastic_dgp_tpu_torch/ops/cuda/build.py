"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/<name>-<hash>.so`` at
the root of the checkout, at first use; the hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and a stale library is never loaded.  Libraries are loaded with
``ctypes``.  Nothing here runs at import time, and nothing is built or
loaded without an ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load_library"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("fused_conditional", "fused_conditional_bwd", "psi2",
           "psi2_bwd", "rbf_gram")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; returns
    (process, temporary path, final path), or None if already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), target


def _finish(name: str, started) -> str:
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)        # atomic: readers never see a partial .so
    return out


def build_all() -> dict:
    """Compile every source not yet built, all nvcc processes at once.
    Returns {name: compiler output} for the sources it compiled."""
    started = {n: _start(n) for n in SOURCES}
    return {n: _finish(n, s) for n, s in started.items() if s is not None}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
