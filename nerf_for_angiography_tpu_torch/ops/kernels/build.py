"""Build a CUDA C++ source of ``csrc/`` into a shared library with a plain C
interface and load it with ``ctypes``.

``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles the source on first
use into the package's ``build/`` directory (listed in ``.gitignore``), keyed
by a hash of the source and the headers it includes, so an edited source or
header is rebuilt and an unchanged one is loaded as it is. A failed build
raises with nvcc's output. Each library keeps its own lock and its own build
log (the ptxas register/shared-memory report of ``-Xptxas -v``); two
libraries can build at the same time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_tag(source: Path) -> str:
    """Hash of a source and of every ``csrc/`` header it includes (by
    ``#include "..."``, recursively), so an edited header rebuilds every
    library that includes it."""
    h = hashlib.sha1()
    seen: set[Path] = set()
    todo = [source]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(text)]
    return h.hexdigest()[:12]


def load_library(name: str) -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<name>.cu`` for sm_90a (unless a build of the same
    source and headers exists) and load it. Returns (library, nvcc's output
    of this build; empty when an earlier build was loaded)."""
    source = CSRC_DIR / f"{name}.cu"
    tag = source_tag(source)
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
