"""First-k-active compaction: a hand-written Hopper kernel and its plain
PyTorch version.

Replaces the TPU kernel ``nerf_for_angiography_tpu/ops/pallas/first_k.py``
``_fka_kernel_t`` (line 50). The CUDA C++ source is ``csrc/first_k.cu``
(sm_90a, one warp per row, a ballot scan and a scatter); its header states
the bound and the design.

Per row of a {0, 1} float mask (..., w), with rank the inclusive running
count of active samples: ``sel[..., j] = min(#{s : rank[s] <= j}, w - 1)``
(int32, the index of the (j+1)-th active sample) and ``mask_k[..., j] =
j < rank[w - 1]`` (float32). Slots past a row's active count hold w - 1 with
mask_k 0; k may exceed w.

The mask is not differentiable (it comes from the occupancy query): the
wrapper is a plain function and raises for a mask that requires grad.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel (building it with ``nvcc`` on first use) or raises.
There is no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .build import load_library, raise_on

# launches since the last reset (the wrapper adds one per launch and nowhere
# else) and the (R, w, k) shapes launched
launches = 0
shapes: set[tuple[int, int, int]] = set()

_lib = None
_lib_lock = threading.Lock()
# nvcc's output of the last build (ptxas register report)
build_log = ""


def reset_counts() -> None:
    global launches
    launches = 0
    shapes.clear()


def first_k_active_reference(mask: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the JAX package's broadcast compare and count
    (ops/occupancy.py::_first_k_active, 'xla'), an (R, w, k) compare summed
    over w."""
    w = mask.shape[-1]
    rank = torch.cumsum(mask, dim=-1)
    j = torch.arange(k, dtype=rank.dtype, device=mask.device)
    sel = (rank[..., :, None] <= j).to(torch.int32).sum(dim=-2, dtype=torch.int32)
    mask_k = (j < rank[..., -1:]).to(torch.float32)
    return torch.clamp(sel, max=w - 1), mask_k


def _load_lib() -> ctypes.CDLL:
    """Build csrc/first_k.cu on first use (ops/kernels/build.py) and bind
    its C interface."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = load_library("first_k")
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.first_k_active_launch.argtypes = [vp, ll, i32, i32, vp, vp, vp]
        lib.first_k_active_launch.restype = i32
        _lib = lib
        return lib


def first_k_active_cuda(mask: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: mask (..., w) float32 on the card -> (sel, mask_k)
    of shape (..., k)."""
    global launches
    lib = _load_lib()
    if mask.dtype != torch.float32:
        raise ValueError(f"mask must be float32, got {mask.dtype}")
    w = mask.shape[-1]
    if w < 1 or k < 1:
        raise ValueError(f"first_k_active needs w >= 1 and k >= 1, got w={w}, k={k}")
    batch = mask.shape[:-1]
    flat = mask.reshape(-1, w).contiguous()
    rows = flat.shape[0]
    sel = torch.empty((rows, k), dtype=torch.int32, device=mask.device)
    mask_k = torch.empty((rows, k), dtype=torch.float32, device=mask.device)
    if rows:
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        code = lib.first_k_active_launch(
            flat.data_ptr(), rows, w, k, sel.data_ptr(), mask_k.data_ptr(), stream
        )
        raise_on(code, "first_k_active")
        launches += 1
        shapes.add((rows, w, k))
    return sel.reshape(*batch, k), mask_k.reshape(*batch, k)


def first_k_active(mask: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    if mask.requires_grad:
        raise ValueError("first_k_active takes a non-differentiable mask (requires_grad=False)")
    if mask.device.type == "cuda":
        return first_k_active_cuda(mask, k)
    if mask.device.type == "cpu":
        return first_k_active_reference(mask, k)
    raise ValueError(f"first_k_active: unsupported device {mask.device}")
