"""The compacted march on the card: two hand-written Hopper kernels.

The CUDA C++ source is ``csrc/march.cu``; its header states the function,
the bound and the design. ``ops/occupancy.py`` dispatches to this module
and assembles its outputs into ``MarchedRays`` / ``BucketedRays``; its op
chain is the plain version (the CPU path, and what the card tests hold the
kernels to, bit for bit).

- ``march_fine_cuda``: one warp a ray. The lattice march's first k
  (``march_rays(compact_k=...)``), the hybrid march's (``_hybrid_fine``,
  its coarse window found in the same warp), the window march
  (``march_rays_window``) and both buckets of a two-bucket march (each ray
  taken through the front kernel's ``perm``), #5's first-k fused in.
- ``march_front_cuda``: the two-bucket marches' coarse window of every ray
  (the front kernel), then the stable counting sort of the rays by window
  span in one block (the sort kernel): ``perm``, equal to
  ``torch.argsort(span, stable=True)``, and its inverse ``inv``.

Counters (host tallies, replayed by ``training/graph.py``): ``launches``
(the kernels' launches), ``march_fused`` (compacted marches the kernels
ran) and ``march_chain`` (compacted marches that took the op chain:
the CPU, a sharded two-bucket march).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .build import load_library, raise_on

# kernel launches, compacted marches run by the kernels and by the chain,
# since the last reset
launches = 0
march_fused = 0
march_chain = 0

LATTICE, HYBRID, WINDOW = 0, 1, 2
# the sort kernel's block (csrc/march.cu kWarps) and the shared memory it
# may take without an opt-in
_WARPS = 8
_SORT_SMEM = 48 * 1024
# the most samples a ray whose spans the sort's histograms hold (one warp)
_MAX_SORT_N = (_SORT_SMEM // 4 - _WARPS) // 2 - 1

_lib = None
_lib_lock = threading.Lock()
# nvcc's output of the last build (ptxas register report)
build_log = ""


def reset_counts() -> None:
    global launches, march_fused, march_chain
    launches = march_fused = march_chain = 0


def count_chain() -> None:
    """A compacted march took the op chain."""
    global march_chain
    march_chain += 1


def sort_warps(n_samples: int) -> int:
    """The warps that share the sort kernel's sort of spans in [0,
    n_samples]: each holds a histogram of n_samples + 1 bins in shared
    memory. 0: the bins do not fit."""
    bins = n_samples + 1
    return max(0, min(_WARPS, (_SORT_SMEM // 4 - _WARPS) // bins - 1))


class _Bucket(ctypes.Structure):
    _fields_ = [("ts", ctypes.c_void_p), ("te", ctypes.c_void_p), ("pos", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("count", ctypes.c_void_p), ("edge", ctypes.c_void_p),
                ("w", ctypes.c_int), ("k", ctypes.c_int)]


class _Args(ctypes.Structure):
    """csrc/march.cu's ``MarchArgs``, field for field."""

    _fields_ = [("o", ctypes.c_void_p), ("d", ctypes.c_void_p), ("aabb", ctypes.c_void_p),
                ("bits", ctypes.c_void_p), ("coarse", ctypes.c_void_p),
                ("perm", ctypes.c_void_p), ("start", ctypes.c_void_p), ("hit", ctypes.c_void_p),
                ("b", _Bucket * 2)] + [
        (name, ctypes.c_int) for name in (
            "rows", "cut", "scatter", "mode", "n", "res", "cres", "occ_stride",
            "c_stride", "c_slack", "c_nprobe")
    ] + [("near", ctypes.c_float), ("step", ctypes.c_float), ("half_step", ctypes.c_float)]


def _load_lib() -> ctypes.CDLL:
    """Build csrc/march.cu on first use (ops/kernels/build.py) and bind its
    C interface."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = load_library("march")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.march_fine_launch.argtypes = [ctypes.POINTER(_Args), vp]
        lib.march_fine_launch.restype = i32
        lib.march_front_launch.argtypes = [ctypes.POINTER(_Args)] + [vp] * 4
        lib.march_front_launch.restype = i32
        lib.march_sort_launch.argtypes = [vp, i32, i32, i32, vp, vp, vp]
        lib.march_sort_launch.restype = i32
        _lib = lib
        return lib


def _args(o, d, aabb, n, near, far, *, bits=None, coarse=None, occ_stride=1,
          mode=LATTICE) -> _Args:
    """The launch's arguments but the buckets and the row layout. ``coarse``:
    the coarse window's plan (table, stride, slack, n_probe) of
    ``ops/occupancy.py::_window_plan``. Floats as the chain's scalars reach
    the card: rounded once from Python's doubles."""
    step = (far - near) / n
    a = _Args()
    a.o, a.d, a.aabb = o.data_ptr(), d.data_ptr(), aabb.data_ptr()
    if bits is not None:
        a.bits, a.res = bits.data_ptr(), bits.shape[0]
    if coarse is not None:
        table, a.c_stride, a.c_slack, a.c_nprobe = coarse
        a.coarse, a.cres = table.data_ptr(), table.shape[0]
    a.rows, a.cut, a.mode, a.n, a.occ_stride = o.shape[0], o.shape[0], mode, n, occ_stride
    a.near, a.step, a.half_step = (float(np.float32(x)) for x in (near, step, step / 2.0))
    return a


def _tables(bits: torch.Tensor, coarse):
    """Contiguous occupancy tables: the caller holds them until its launch
    is enqueued (a grid restored from a file may hold a strided view)."""
    if coarse is not None:
        coarse = (coarse[0].contiguous(), *coarse[1:])
    return bits.contiguous(), coarse


def _rays(origins: torch.Tensor, directions: torch.Tensor, aabb: torch.Tensor):
    """(R, 3) float32 contiguous rays and the box the kernels read."""
    if directions.requires_grad and torch.is_grad_enabled():
        raise ValueError("the march kernels pass no gradient to the directions")
    for name, t in (("origins", origins), ("directions", directions), ("aabb", aabb)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"the march kernels take float32 CUDA {name}, got {t.dtype} on "
                             f"{t.device}")
    if origins.shape[-1] != 3 or origins.shape != directions.shape or aabb.numel() != 6:
        raise ValueError(f"rays {tuple(origins.shape)} / {tuple(directions.shape)} and box "
                         f"{tuple(aabb.shape)} do not fit the march kernels")
    return (origins.detach().reshape(-1, 3).contiguous(), directions.reshape(-1, 3).contiguous(),
            aabb.contiguous())


def _outputs(rows: int, k: int, w: int, dev) -> tuple[list[torch.Tensor], _Bucket]:
    """One bucket's output tensors (t_starts, t_ends, positions, mask,
    active_count, edge_active) and their _Bucket."""
    f32 = dict(dtype=torch.float32, device=dev)
    out = [torch.empty((rows, k), **f32), torch.empty((rows, k), **f32),
           torch.empty((rows, k, 3), **f32), torch.empty((rows, k), **f32),
           torch.empty((rows,), dtype=torch.int32, device=dev),
           torch.empty((rows,), dtype=torch.bool, device=dev)]
    b = _Bucket(*(t.data_ptr() for t in out), w, k)
    return out, b


def _launch_fine(a: _Args, dev) -> None:
    global launches
    lib = _load_lib()
    if a.rows:
        code = lib.march_fine_launch(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
        raise_on(code, "march_fine")
        launches += 1


def march_fine_cuda(origins, directions, aabb, bits, n, near, far, mode, w, k, *,
                    occ_stride=1, coarse=None) -> list[torch.Tensor]:
    """One launch: the lattice (``mode`` LATTICE, w = n), hybrid (HYBRID, w
    = the window width) or window (WINDOW, w = k) march of rays (..., 3) ->
    [t_starts, t_ends, positions, mask, active_count, edge_active] with the
    rays' batch shape. The hybrid and window marches take ``coarse``, the
    coarse window's plan; ``bits`` is the (res,)^3 occupancy (the window
    march does not read it)."""
    global march_fused
    batch = origins.shape[:-1]
    o, d, box = _rays(origins, directions, aabb)
    bits, coarse = _tables(bits, coarse)
    if min(w, k) < 1:
        raise ValueError(f"the march kernels need a window and k of at least 1, got w={w}, k={k}")
    a = _args(o, d, box, n, near, far, bits=bits, coarse=coarse, occ_stride=occ_stride,
              mode=mode)
    out, a.b[0] = _outputs(o.shape[0], k, w, o.device)
    a.b[1] = a.b[0]
    _launch_fine(a, o.device)
    march_fused += 1
    return [t.reshape(batch + t.shape[1:]) for t in out]


def march_front_cuda(o, d, box, n, near, far, coarse):
    """The front and sort kernels on (R, 3) rays: (start_idx int32, any_hit
    bool, perm, inv int64), the coarse window's start and hit of every ray
    and the stable sort of the rays by window span."""
    global launches
    lib = _load_lib()
    rows, dev = o.shape[0], o.device
    sw = sort_warps(n)
    if sw < 1:
        raise ValueError(f"the march kernels' sort takes at most {_MAX_SORT_N} samples a ray, "
                         f"got {n}")
    a = _args(o, d, box, n, near, far, coarse=coarse, mode=HYBRID)
    start = torch.empty((rows,), dtype=torch.int32, device=dev)
    hit = torch.empty((rows,), dtype=torch.bool, device=dev)
    span = torch.empty((rows,), dtype=torch.int32, device=dev)
    perm = torch.empty((rows,), dtype=torch.int64, device=dev)
    inv = torch.empty((rows,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.march_front_launch(ctypes.byref(a), start.data_ptr(), hit.data_ptr(),
                                  span.data_ptr(), stream)
    raise_on(code, "march_front")
    code = lib.march_sort_launch(span.data_ptr(), rows, n, sw, perm.data_ptr(), inv.data_ptr(),
                                 stream)
    raise_on(code, "march_sort")
    launches += 2
    return start, hit, perm, inv


def march_buckets_cuda(origins, directions, aabb, bits, n, near, far, cut, lo, hi, *,
                       occ_stride=1, coarse=None, scatter=False):
    """The two-bucket march of (R, 3) rays in three launches: the front and
    sort kernels, then the fine kernel on the span-sorted rows, those below
    ``cut`` at ``lo`` = (w_lo, k_lo), the rest at ``hi`` = (w_cap, k).
    Returns (lo outputs, hi outputs, perm, inv), each outputs list as
    march_fine_cuda's;
    with ``scatter`` (one k: ``lo[1] == hi[1]``) the rows go back to the
    input order as ONE outputs list, returned twice."""
    global march_fused
    o, d, box = _rays(origins, directions, aabb)
    bits, coarse = _tables(bits, coarse)
    rows, dev = o.shape[0], o.device
    if not 0 < cut < rows or scatter and lo[1] != hi[1]:
        raise ValueError(f"two buckets need 0 < cut < rays (cut {cut}, {rows} rays) and, "
                         f"scattered, one k ({lo}, {hi})")
    start, hit, perm, inv = march_front_cuda(o, d, box, n, near, far, coarse)
    a = _args(o, d, box, n, near, far, bits=bits, coarse=coarse, occ_stride=occ_stride,
              mode=HYBRID)
    a.perm, a.start, a.hit = perm.data_ptr(), start.data_ptr(), hit.data_ptr()
    a.cut, a.scatter = cut, int(scatter)
    if scatter:
        out_lo, a.b[0] = _outputs(rows, lo[1], lo[0], dev)
        out_hi, a.b[1] = out_lo, _Bucket(*(t.data_ptr() for t in out_lo), hi[0], hi[1])
    else:
        out_lo, a.b[0] = _outputs(cut, lo[1], lo[0], dev)
        out_hi, a.b[1] = _outputs(rows - cut, hi[1], hi[0], dev)
    _launch_fine(a, dev)
    march_fused += 1
    return out_lo, out_hi, perm, inv
