"""The whole-train-step gradient of a rectangular march: a hand-written
Hopper kernel and its plain PyTorch version.

Replaces the TPU kernel ``nerf_for_angiography_tpu/ops/pallas/fused_step.py``
``_fs_kernel`` (line 79), reached through ``fused_step_grads`` (line 202).
The CUDA C++ source is ``csrc/fused_step.cu`` over the layer chains of
``csrc/mlp_chain.cuh`` and ``csrc/mlp_wgmma.cuh``; its header states the
bound and the design: a list of the 16-point tiles holding a sample with
mask != 0, the forward over those tiles on warpgroup MMA keeping sigma, a
per-ray composite scan over rows staged in shared memory, and the MLP
backward of the draws, which works only on tiles holding a sample with draw
!= 0 and stores its scratch in the tile-fragment layout. Six launches and a
memset in one call, no float atomics. The list of active tiles lives in the
backward's dz scratch, which the chain overwrites only after the forward has
read it.

The function (the TPU kernel's cast points): x = bf16(o s + (d s) t_mid);
the bf16 layer chain and the f32 head; sigma = sigmoid(raw); keep = mask *
[exp(-exclusive sum of sigma step mask) >= eps]; pixel = exp(-sum sigma step
keep); coef = -(2/N)(pixel - target) pixel step; draw = coef keep sigma
(1 - sigma); the MLP backward of draw with dh = bf16(w_out draw), relu masks
from the bf16 activations and dW/db accumulated in f32. The gradients are
those of sum((pixel - target)^2) / N in the plist layout; there is no dx.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the kernel
(building it with ``nvcc`` on first use) or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import fused_mlp as fm
from .build import load_library, raise_on

# launches since the last reset (the wrapper adds one per launch and nowhere
# else) and the (R, k) shapes launched
fused_step_launches = 0
shapes: set[tuple[int, int]] = set()

# the kernel forms sample indices in 32 bits
_MAX_SAMPLES = 1 << 31

_lib = None
_lib_lock = threading.Lock()
# nvcc's output of the last build (ptxas register report)
build_log = ""


def reset_counts() -> None:
    global fused_step_launches
    fused_step_launches = 0
    shapes.clear()


def _check_march(origins, directions, t_mid, mask, targets) -> tuple[int, int]:
    r, k = t_mid.shape
    want = {"origins": (r, 3), "directions": (r, 3), "mask": (r, k), "targets": (r,)}
    for name, t in zip(want, (origins, directions, mask, targets)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    return r, k


def draws_reference(
    packed: fm.PackedMLP, origins, directions, t_mid, mask, targets, *,
    step: float, early_stop_eps: float, n_rays_loss: int, input_scale: float = 1.0,
):
    """The plain forward and composite: (pixels (R,), draws (R, k) f32 =
    dL/draw of every sample, bf16 input (R k, 3), bf16 activations).

    origins/directions (R, 3), t_mid/mask (R, k) depth-ascending, targets
    (R,); ``step`` is every sample's dist, ``n_rays_loss`` the loss mean's
    divisor N."""
    r, k = _check_march(origins, directions, t_mid, mask, targets)
    o = origins.float() * input_scale
    d = directions.float() * input_scale
    x = (o[:, None, :] + d[:, None, :] * t_mid.float()[..., None]).reshape(-1, 3)
    xb, acts = fm._forward_acts(packed, x)
    sigma = torch.sigmoid(fm._head(packed, acts)).reshape(r, k)
    mask = mask.float()
    # the composite in depth order: S_prune (all active samples) drives the
    # early-stop keep, S_comp (kept samples) the pixel
    s_prune = torch.zeros((r,), dtype=torch.float32, device=x.device)
    s_comp = torch.zeros_like(s_prune)
    keep = torch.empty_like(sigma)
    for j in range(k):
        keep[:, j] = mask[:, j] * (torch.exp(-s_prune) >= early_stop_eps).float()
        s_comp = s_comp + sigma[:, j] * (step * keep[:, j])
        s_prune = s_prune + sigma[:, j] * (step * mask[:, j])
    pixel = torch.exp(-s_comp)
    g_scale = 2.0 / float(n_rays_loss)
    coef = -(g_scale * (pixel - targets.float())) * pixel * step
    draw = coef[:, None] * keep * sigma * (1.0 - sigma)
    return pixel, draw, xb, acts


def fused_step_grads_reference(
    packed: fm.PackedMLP, origins, directions, t_mid, mask, targets, *,
    step: float, early_stop_eps: float, n_rays_loss: int, input_scale: float = 1.0,
):
    """The plain version: (pixels (R,) f32, grads in the plist layout), for
    draws_reference's inputs."""
    pixel, draw, xb, acts = draws_reference(
        packed, origins, directions, t_mid, mask, targets, step=step,
        early_stop_eps=early_stop_eps, n_rays_loss=n_rays_loss, input_scale=input_scale)
    grads, _ = fm.backward_from_acts(packed, xb, acts, draw.reshape(-1))
    return pixel, grads


def _load_lib() -> ctypes.CDLL:
    """Build csrc/fused_step.cu on first use (ops/kernels/build.py) and bind
    its C interface."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = load_library("fused_step")
        vp, ll, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.fused_step_sizes.argtypes = [i32, i32, i32, ctypes.POINTER(ll)]
        lib.fused_step_sizes.restype = None
        lib.fused_step_grads.argtypes = [
            vp, vp, vp, vp, vp, ll, i32, f32, f32, f32, f32, vp, vp, vp, vp, vp, i32, i32,
            vp, vp, vp, vp, vp, vp, vp, i32, ll, i32, vp, vp,
        ]
        lib.fused_step_grads.restype = i32
        lib.fused_step_scratch_rows.argtypes = [ll]
        lib.fused_step_scratch_rows.restype = ll
        lib.fused_step_scan.argtypes = [vp, vp, vp, ll, i32, f32, f32, f32, vp, vp, i32, vp]
        lib.fused_step_scan.restype = i32
        _lib = lib
        return lib


def fused_step_grads_cuda(
    packed: fm.PackedMLP, origins, directions, t_mid, mask, targets, *,
    step: float, early_stop_eps: float, n_rays_loss: int, input_scale: float = 1.0,
):
    """Launch the kernel on the card: the same function and results as
    fused_step_grads_reference."""
    global fused_step_launches
    lib = _load_lib()
    r, k = _check_march(origins, directions, t_mid, mask, targets)
    dev = t_mid.device
    for name, t in zip(("origins", "directions", "t_mid", "mask", "targets"),
                       (origins, directions, t_mid, mask, targets)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    if k < 1 or r * k >= _MAX_SAMPLES:
        raise ValueError(f"fused_step_grads needs 1 <= k and R k < 2^31, got R={r}, k={k}")
    f, nh = packed.width, packed.n_hidden
    n_sms = fm._num_sms(dev)
    sizes = (ctypes.c_longlong * 5)()
    lib.fused_step_sizes(f, nh, n_sms, sizes)
    smem, stride, n_grad, mask_slots, quantum = list(sizes)
    fm.check_packed(packed, dev, smem)
    p = r * k
    s = fm.BwdScratch.make(p, f, nh, n_sms, stride, mask_slots, quantum, dev,
                           rows=lib.fused_step_scratch_rows(p))
    sigma = torch.empty((p,), dtype=torch.float32, device=dev)
    draw = torch.empty((p,), dtype=torch.float32, device=dev)
    pixel = torch.empty((r,), dtype=torch.float32, device=dev)
    flat = torch.empty((n_grad,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.fused_step_grads(
        origins.data_ptr(), directions.data_ptr(), t_mid.data_ptr(), mask.data_ptr(),
        targets.data_ptr(), r, k, input_scale, step, early_stop_eps, 2.0 / float(n_rays_loss),
        packed.w_in.data_ptr(), packed.w_hid.data_ptr(), packed.bias.data_ptr(),
        packed.w_out.data_ptr(), packed.b_out.data_ptr(), f, nh, sigma.data_ptr(),
        draw.data_ptr(), pixel.data_ptr(), *s.args(), n_sms, flat.data_ptr(), stream,
    )
    raise_on(code, "fused_step")
    fused_step_launches += 1
    shapes.add((r, k))
    return pixel, fm._unflatten_grads(flat, f, nh)


def fused_step_scan_cuda(sigma, mask, targets, *, step: float, early_stop_eps: float,
                         n_rays_loss: int, serial: bool = False):
    """The kernel's composite scan alone on the card, for checks: sigma and
    mask (R, k), targets (R,) f32 -> (pixels (R,), draws (R, k)); with
    ``serial`` the one-thread-a-ray reference it is held to bit for bit.
    sigma is used only where mask != 0. Not counted in
    fused_step_launches."""
    lib = _load_lib()
    r, k = sigma.shape
    dev = sigma.device
    for name, t, shape in (("sigma", sigma, (r, k)), ("mask", mask, (r, k)),
                           ("targets", targets, (r,))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name} must be contiguous float32 {shape} on {dev}")
    pixel = torch.empty((r,), dtype=torch.float32, device=dev)
    draw = torch.empty((r, k), dtype=torch.float32, device=dev)
    code = lib.fused_step_scan(
        sigma.data_ptr(), mask.data_ptr(), targets.data_ptr(), r, k, step, early_stop_eps,
        2.0 / float(n_rays_loss), pixel.data_ptr(), draw.data_ptr(), int(serial),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(code, "fused_step scan")
    return pixel, draw


def fused_step_grads(
    plist, origins, directions, t_mid, mask, targets, *,
    step: float, early_stop_eps: float, n_rays_loss: int, input_scale: float = 1.0,
):
    """One-call train-step gradient for a rectangular march (the JAX
    ``fused_step_grads`` signature): plist [(W_in (3,F), b_in), (W, b)...,
    (w_out (F,1), b_out)]; returns (pixels (R,) f32, grads in that layout),
    the gradient of sum((pixel - target)^2) / n_rays_loss. Dispatch by the
    device of t_mid."""
    packed = fm.pack_params(plist)
    kw = dict(step=step, early_stop_eps=early_stop_eps, n_rays_loss=n_rays_loss,
              input_scale=input_scale)
    if t_mid.device.type == "cuda":
        return fused_step_grads_cuda(packed, origins, directions, t_mid, mask, targets, **kw)
    if t_mid.device.type == "cpu":
        return fused_step_grads_reference(packed, origins, directions, t_mid, mask, targets,
                                          **kw)
    raise ValueError(f"fused_step_grads: unsupported device {t_mid.device}")
