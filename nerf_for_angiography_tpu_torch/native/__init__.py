"""The repository's native host libraries, bound with ``ctypes`` (the port's
counterpart of ``nerf_for_angiography_tpu/native/__init__.py``).

Two C++ sources under the repository's ``native/`` belong to both packages:

* ``csv_loader.cpp``: the per-ray CSV parser (mmap, ``std::from_chars``
  across threads) behind ``load_data``;
* ``json_export.cpp``: the cag-vis JSON writer (``std::to_chars``, the
  shortest round-trip form, so ``json.load`` reads back the values given)
  behind the sweep's per-angle and heatmap JSONs.

The host C++ compiler builds each on first use into the port's build
directory (``ops/kernels/build.py``: the package's ``build/``, listed in
``.gitignore``, or ``$NERF_ANGIO_BUILD_DIR``), keyed by a hash of the
source, the compiler's flags and its ``--version`` output, written to a
temporary name and renamed, so several processes can build at once. The
JAX package's own builds (``native/*.so``) are never read or written. A build
that fails, a file that does not parse and a write that fails raise: no
caller falls back to another path.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops.kernels.build import BUILD_DIR, build_tag, compiler_version

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SOURCES = {"csvloader": "csv_loader.cpp", "jsonexport": "json_export.cpp"}
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _compiler() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) found: the native libraries "
                       "are built from source")


def _build(name: str) -> ctypes.CDLL:
    source = NATIVE_DIR / _SOURCES[name]
    compiler = _compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}_{build_tag(source, CXX_FLAGS, compiler_version(compiler))}.so"
    if not so.exists():
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.{threading.get_ident()}.so"
        cmd = [compiler, *CXX_FLAGS, str(source), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {source} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def get_lib(name: str) -> ctypes.CDLL:
    """The library ``name`` ('csvloader' or 'jsonexport'), built on first
    use, with its functions' argument and result types declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        lib = _build(name)
        if name == "csvloader":
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.rays_csv_count.restype = ctypes.c_int64
            lib.rays_csv_count.argtypes = [ctypes.c_char_p]
            lib.rays_csv_parse.restype = ctypes.c_int64
            lib.rays_csv_parse.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, f32p, f32p, f32p, f32p, i32p, i32p, i32p,
                ctypes.POINTER(ctypes.c_int32),
            ]
        else:
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.write_angle_json.restype = ctypes.c_int64
            lib.write_angle_json.argtypes = [ctypes.c_char_p, f64p, f64p, f64p, ctypes.c_int64]
            lib.write_heatmap_json.restype = ctypes.c_int64
            lib.write_heatmap_json.argtypes = [ctypes.c_char_p, f64p, f64p, f64p, f64p,
                                               ctypes.c_int64]
        _libs[name] = lib
        return lib


def load_rays_csv(path: str) -> dict:
    """Parse the per-ray CSV with the native loader: origins / directions
    (N, 3) f32, pixel_values / weights (N,) f32, x_positions / y_positions /
    image_ids (N,) i32 (ids in order of first appearance) and num_views."""
    lib = get_lib("csvloader")
    n = lib.rays_csv_count(os.fsencode(path))
    if n < 0:
        raise FileNotFoundError(f"{path}: cannot be opened or is empty")
    if n == 0:
        raise ValueError(f"{path}: no rows after the header")
    out = dict(origins=np.empty((n, 3), np.float32), directions=np.empty((n, 3), np.float32),
               pixel_values=np.empty(n, np.float32), weights=np.empty(n, np.float32),
               x_positions=np.empty(n, np.int32), y_positions=np.empty(n, np.int32),
               image_ids=np.empty(n, np.int32))
    n_views = ctypes.c_int32(0)
    got = lib.rays_csv_parse(os.fsencode(path), n, out["origins"], out["directions"],
                             out["pixel_values"], out["weights"], out["x_positions"],
                             out["y_positions"], out["image_ids"], ctypes.byref(n_views))
    if got != n:
        raise ValueError(f"{path}: the native loader parsed {got} of {n} rows")
    out["num_views"] = int(n_views.value)
    return out


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float64).reshape(-1))


def _check_write(code: int, path: str) -> None:
    if code != 0:
        raise OSError(f"{path}: the native JSON writer failed (code {code})")


def write_angle_json(path: str, pred, org, diff) -> None:
    """{"pred": [...], "org": [...], "diff": [...]}: one sweep view's flat
    image arrays."""
    p, o, d = _f64(pred), _f64(org), _f64(diff)
    if not p.size == o.size == d.size:
        raise ValueError(f"pred / org / diff sizes differ: {p.size}, {o.size}, {d.size}")
    _check_write(get_lib("jsonexport").write_angle_json(os.fsencode(path), p, o, d, p.size),
                 path)


def write_heatmap_json(path: str, rad, theta, angles, vals) -> None:
    """{"rad", "theta", "angles": [[theta, phi], ...], "vals"}: one polar
    heatmap."""
    r, t, a, v = _f64(rad), _f64(theta), _f64(angles), _f64(vals)
    if not (r.size == t.size == v.size and a.size == 2 * r.size):
        raise ValueError(f"rad / theta / angles / vals sizes differ: {r.size}, {t.size}, "
                         f"{a.size} (2 a row), {v.size}")
    _check_write(get_lib("jsonexport").write_heatmap_json(os.fsencode(path), r, t, a, v,
                                                          r.size), path)
