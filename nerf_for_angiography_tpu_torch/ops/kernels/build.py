"""Build a CUDA C++ source of ``csrc/`` into a shared library with a plain C
interface and load it with ``ctypes``.

``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles the source on first
use into the package's ``build/`` directory (listed in ``.gitignore``), keyed
by a hash of the source, so an edited source is rebuilt and an unchanged one
is loaded as it is. A failed build raises with nvcc's output. Each library
keeps its own lock and its own build log (the ptxas register/shared-memory
report of ``-Xptxas -v``); two libraries can build at the same time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's kernels are built from source")


def load_library(name: str) -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<name>.cu`` for sm_90a (unless a build of the same
    source exists) and load it. Returns (library, nvcc's output of this
    build; empty when an earlier build was loaded)."""
    source = CSRC_DIR / f"{name}.cu"
    tag = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}_{tag}.so"
    log = ""
    if not so.exists():
        tmp = BUILD_DIR / f".lib{name}_{tag}.{os.getpid()}.so"
        cmd = [
            nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(source),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log


def raise_on(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (cudaGetLastError())."""
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")
