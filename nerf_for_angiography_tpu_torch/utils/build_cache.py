"""The port's persistent build cache (the counterpart of
``nerf_for_angiography_tpu/utils/xla_cache.py``).

The JAX package caches its XLA executables across processes
(``JAX_COMPILATION_CACHE_DIR``). The port compiles no XLA: what it builds
are the CUDA kernel libraries (``nvcc``, ``ops/kernels/build.py``) and the
native host libraries (the host ``c++``, ``native/__init__.py``). Both land
in one build directory, keyed by source, headers, flags and compiler
version, so a process loads what an earlier one built. The directory is the
package's ``build/`` (listed in ``.gitignore``) unless
``$NERF_ANGIO_BUILD_DIR`` names another, or ``enable_persistent_cache``
moves it for this process.
"""

from __future__ import annotations

import os
from pathlib import Path

from .. import native
from ..ops.kernels import build


def enable_persistent_cache(path: str | None = None) -> str:
    """Point both builders at ``path`` (default ``$NERF_ANGIO_BUILD_DIR``,
    else the package's ``build/``) for the rest of this process, creating
    it. Call it before the first kernel or native library is loaded (a
    loaded library stays loaded). Returns the directory."""
    d = Path(path) if path is not None else build.default_build_dir()
    os.makedirs(d, exist_ok=True)
    build.BUILD_DIR = native.BUILD_DIR = d
    return str(d)
