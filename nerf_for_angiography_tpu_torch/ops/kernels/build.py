"""Build a CUDA C++ source of ``csrc/`` into a shared library with a plain C
interface and load it with ``ctypes``.

``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles the source on first
use into the build directory, keyed by a hash of the source, the headers it
includes, the compiler's flags and its ``--version`` output (read once a
process), so an edited source or header, another flag or another compiler
is rebuilt and an unchanged build is loaded as it is. The build directory
is the package's ``build/`` (listed in ``.gitignore``), or the one
``$NERF_ANGIO_BUILD_DIR`` names (``utils.build_cache.enable_persistent_cache``
sets it for a process). A failed build raises with nvcc's output. Each
library keeps its own lock and its own build log (the ptxas
register/shared-memory report of ``-Xptxas -v``); two libraries can build
at the same time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
# the environment variable that moves every build of the port (the role
# JAX_COMPILATION_CACHE_DIR plays for the JAX package's compiles)
BUILD_DIR_ENV = "NERF_ANGIO_BUILD_DIR"


def default_build_dir() -> Path:
    """``$NERF_ANGIO_BUILD_DIR``, else the package's ``build/``."""
    env = os.environ.get(BUILD_DIR_ENV)
    return Path(env) if env else Path(__file__).resolve().parents[2] / "build"


BUILD_DIR = default_build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's kernels are built from source")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


@functools.lru_cache(maxsize=None)
def compiler_version(compiler: str) -> str:
    """``<compiler> --version``'s output, read once a process; raises if the
    compiler does not run."""
    proc = subprocess.run([compiler, "--version"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} --version failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build_tag(source: Path, flags, version: str) -> str:
    """The build's key: ``source_tag`` of the source and its headers, the
    compiler's flags (the command line but its input and output paths) and
    its ``--version`` output."""
    h = hashlib.sha1(source_tag(source).encode())
    h.update("\0".join(flags).encode() + b"\1" + version.encode())
    return h.hexdigest()[:12]


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
    source, headers, flags and compiler exists) and load it. Returns
    (library, nvcc's output of this build; empty when an earlier build was
    loaded)."""
    source = CSRC_DIR / f"{name}.cu"
    compiler = nvcc()
    tag = build_tag(source, NVCC_FLAGS, compiler_version(compiler))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}_{tag}.so"
    log = ""
    if not so.exists():
        tmp = BUILD_DIR / f".lib{name}_{tag}.{os.getpid()}.so"
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(source)]
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
