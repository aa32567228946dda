"""Fused encoded CPPN-MLP forward/backward (fourier / BARF positional
encodings): hand-written Hopper kernels and their plain PyTorch versions.

Replaces the TPU kernels ``nerf_for_angiography_tpu/ops/pallas/fused_mlp.py``
``_fwd_kernel_enc`` (line 539) and ``_bwd_kernel_enc`` (line 551), reached
through ``fused_mlp_enc_raw`` (line 699), whose signature and custom VJP
(lines 714-759) ``fused_mlp_enc_raw`` here keeps. The CUDA C++ source is
``csrc/fused_mlp_enc.cu``: the forward (#3) is ``csrc/mlp_wgmma.cuh``'s
``wgmma_enc_fwd_kernel`` (warpgroup MMA, the features of ``EncX`` formed in
registers as the first layer's A operand), the backward (#4) the layer
chain of ``csrc/mlp_chain.cuh`` over ``GatedEncX``; its header states the
bound and the design. A module of its own (not a
section of ``fused_mlp.py``): its own library builds beside the other three
in parallel, and its launch counters stay apart from kernels #1/#2's, so a
run shows which pair it went through. The backward's chain adds its active
tiles into kernel #2's device counter (``fused_mlp.active_tiles``): a job
runs one of the two backwards, so the counter reads the one it ran.

The function, at the TPU kernels' cast points: v_j = a_j x_{j%3} (one f32
product; a_j = 2 pi coeff_j for fourier, 2^{j//3} pi for BARF); the encoded
block [x, sin(v) w, cos(v) w] rounded to bf16 (w = 1 for fourier, the BARF
window at the current alpha otherwise); then the bf16 layer chain and f32
head of ``fused_mlp.py``. The backward gives the chain's gradients with
dW_in (E, F) against the encoded block, dx = A^T dv in f32 (dv = (1 | cos v
| -sin v) dencw w, dencw = dz_0 W_in), and for fourier dcoeff_j = 2 pi
(dA[sin j] + dA[cos j]) with dA = sum over the points of dv x (x in f32).
The BARF window is a schedule: it gets no gradient.

The kernels take the encoded block's columns in pair order (``EncX`` in
``csrc/mlp_chain.cuh``): [x0, x1, x2, 0, sin_0, cos_0, sin_1, cos_1, ...,
0...] padded to KE = 16 ceil((4 + 6L) / 16) columns (48 at L = 5), so one
sincosf serves both features of a band; ``pack_enc_params`` permutes W_in's
rows into that order and the gradients are permuted back.

The backward kernel (#4) works only on 16-point tiles whose upstream
gradient g is not all zero, as kernel #2 does: the other points add exact
zeros to every gradient and to dA, and their dx stays 0. Its scratch (2 x
(n_hidden + 1) x P x F bf16 of activations and dz, and P x KE bf16 of the
encoded features its chain multiplied, P rounded up to whole tiles) is
written for the active tiles alone, and its weight gradients read it back.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel (building it with ``nvcc`` on first use) or raises.
There is no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from ...utils.profiling import annotate
from . import fused_mlp as fm
from .build import load_library, raise_on

# launches of each kernel since the last reset (the wrappers add one per
# launch and nowhere else), and the backward's launched 16-point tiles
# (ceil(P / 16) a launch) and points
enc_fwd_launches = 0
enc_bwd_launches = 0
enc_bwd_tiles = 0
enc_bwd_points = 0

_lib = None
_lib_lock = threading.Lock()
# nvcc's output of the last build (ptxas register/shared-memory report)
build_log = ""


def reset_counts() -> None:
    global enc_fwd_launches, enc_bwd_launches, enc_bwd_tiles, enc_bwd_points
    enc_fwd_launches = 0
    enc_bwd_launches = 0
    enc_bwd_tiles = 0
    enc_bwd_points = 0


def enc_width(n_basis: int) -> int:
    """KE: the kernels' encoded input width for L = ``n_basis`` bands."""
    return 16 * -(-(4 + 6 * n_basis) // 16)


@functools.lru_cache(maxsize=16)
def kernel_columns(n_basis: int, device: torch.device | None = None) -> torch.Tensor:
    """For each encoded feature in the JAX order [x (3), sin rows (3L), cos
    rows (3L)], its column in the kernels' pair order. Cached per device:
    every call reads it, and a fresh copy to the card would make the host
    wait for the stream."""
    j = torch.arange(3 * n_basis)
    return torch.cat([torch.arange(3), 4 + 2 * j, 5 + 2 * j]).to(device)


def enc_arrays(kind: str, n_basis: int, enc: torch.Tensor):
    """(a, w), both (3L,) f32 on enc's device: a_j = 2 pi coeff_j and w = 1
    for fourier (``enc`` = the coefficients), a_j = 2^{j//3} pi and w = the
    window for BARF (``enc`` = the barf_weights window), as the JAX
    ``_enc_arrays`` builds its A and w_rows."""
    if kind == "fourier":
        return 2.0 * math.pi * enc.float(), torch.ones_like(enc, dtype=torch.float32)
    if kind == "barf":
        k = torch.arange(n_basis, dtype=torch.float32, device=enc.device).repeat_interleave(3)
        return torch.pow(2.0, k) * math.pi, enc.float()
    raise ValueError(f"unknown encoding kind {kind!r}")


def pack_enc_params(plist, n_basis: int) -> fm.PackedMLP:
    """[(W_in (E, F), b_in), (W (F, F), b)..., (w_out, b_out)] with E = 3 +
    6L -> PackedMLP whose w_in is (F, KE) bf16 with its columns in the
    kernels' pair order (zero elsewhere)."""
    (w_in, b_in), *rest = plist
    packed = fm.pack_params([(w_in[:3], b_in), *rest])
    f = w_in.shape[1]
    w_in_k = torch.zeros((f, enc_width(n_basis)), dtype=torch.bfloat16, device=w_in.device)
    w_in_k[:, kernel_columns(n_basis, w_in.device)] = w_in.detach().T.to(torch.bfloat16)
    return packed._replace(w_in=w_in_k)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the card-side yardstick)
# ---------------------------------------------------------------------------


def encode(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor, ke: int):
    """x (P, 3) f32 -> (the encoded block (P, KE) f32 in pair order, before
    its bf16 rounding; v (P, 3L))."""
    n = a.shape[0]
    v = a * x[:, torch.arange(n, device=x.device) % 3]
    enc = torch.zeros((x.shape[0], ke), dtype=torch.float32, device=x.device)
    enc[:, :3] = x
    enc[:, 4 : 4 + 2 * n : 2] = torch.sin(v) * w
    enc[:, 5 : 5 + 2 * n : 2] = torch.cos(v) * w
    return enc, v


def fused_mlp_enc_fwd_reference(packed: fm.PackedMLP, a, w, x: torch.Tensor) -> torch.Tensor:
    """x (P, 3) f32 -> raw density (P,) f32, plain PyTorch."""
    enc, _ = encode(x, a, w, packed.w_in.shape[1])
    _, acts = fm._forward_acts(packed, enc)
    return fm._head(packed, acts)


def fused_mlp_enc_bwd_reference(packed: fm.PackedMLP, a, w, x: torch.Tensor, g: torch.Tensor):
    """Backward of fused_mlp_enc_fwd_reference for dL/draw = g (P,).

    Returns (grads in the plist layout with dW_in (KE, F) in pair order, dA
    (KE,) in pair order: entries 4 + 2j / 5 + 2j hold the sin / cos row j's
    sum of dv x_{j%3}, dx (P, 3) f32)."""
    n, ke = a.shape[0], packed.w_in.shape[1]
    enc, v = encode(x, a, w, ke)
    xb, acts = fm._forward_acts(packed, enc)
    grads, dzf = fm.backward_from_acts(packed, xb, acts, g)
    dencw = dzf @ packed.w_in.float()
    dv_sin = torch.cos(v) * (dencw[:, 4 : 4 + 2 * n : 2] * w)
    dv_cos = -torch.sin(v) * (dencw[:, 5 : 5 + 2 * n : 2] * w)
    xc = x[:, torch.arange(n, device=x.device) % 3]
    da = torch.zeros((ke,), dtype=torch.float32, device=x.device)
    da[4 : 4 + 2 * n : 2] = (dv_sin * xc).sum(0)
    da[5 : 5 + 2 * n : 2] = (dv_cos * xc).sum(0)
    dx = dencw[:, :3] + (a * dv_sin + a * dv_cos).reshape(-1, n // 3, 3).sum(1)
    return grads, da, dx


# ---------------------------------------------------------------------------
# the CUDA kernels: build on first use, bind with ctypes
# ---------------------------------------------------------------------------


def _load_lib() -> ctypes.CDLL:
    """Build csrc/fused_mlp_enc.cu on first use (ops/kernels/build.py) and
    bind its C interface."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = load_library("fused_mlp_enc")
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.fused_mlp_enc_sizes.argtypes = [i32, i32, i32, i32, i32, vp]
        lib.fused_mlp_enc_sizes.restype = None
        lib.fused_mlp_enc_fwd.argtypes = [
            vp, ll, vp, vp, i32, i32, vp, vp, vp, vp, vp, i32, i32, vp, i32, vp,
        ]
        lib.fused_mlp_enc_fwd.restype = i32
        lib.fused_mlp_enc_bwd.argtypes = [
            vp, vp, ll, vp, vp, i32, i32, vp, vp, vp, vp, vp, i32, i32, vp, vp, vp, vp, i32, ll,
            i32, vp, vp, vp, vp, vp, vp, vp,
        ]
        lib.fused_mlp_enc_bwd.restype = i32
        lib.fused_mlp_enc_scratch_rows.argtypes = [ll]
        lib.fused_mlp_enc_scratch_rows.restype = ll
        _lib = lib
        return lib


def _sizes(lib, packed: fm.PackedMLP, n_enc: int, n_sms: int) -> list[int]:
    """fused_mlp_enc_sizes: [smem, partial stride, grad size, mask slots,
    chunk quantum, dA slot floats]."""
    out = (ctypes.c_longlong * 6)()
    lib.fused_mlp_enc_sizes(packed.width, packed.n_hidden, packed.w_in.shape[1], n_enc, n_sms,
                            ctypes.addressof(out))
    return list(out)


def _check_kernel_inputs(packed: fm.PackedMLP, a, w, x: torch.Tensor, lib, n_sms: int):
    """Raise on inputs the kernels do not take; returns (P, the sizes)."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (P, 3) float32, got {tuple(x.shape)} {x.dtype}")
    n = a.shape[0]
    for name, t in (("a", a), ("w", w)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (n,) or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name} must be contiguous ({n},) float32 on x's device")
    f, ke = packed.width, packed.w_in.shape[1]
    if n % 3 or ke != enc_width(n // 3) or ke > min(f, 64):
        raise ValueError(
            f"encoded kernels need KE = 16 ceil((4 + 6L) / 16) <= min(F, 64); got KE={ke}, "
            f"L={n / 3}, F={f}"
        )
    sizes = _sizes(lib, packed, n, n_sms)
    fm.check_packed(packed, x.device, sizes[0])
    return x.shape[0], sizes


def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_mlp_enc_fwd_cuda(packed: fm.PackedMLP, a, w, x: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: x (P, 3) f32 on the card -> (P,) f32."""
    global enc_fwd_launches
    lib = _load_lib()
    n_sms = _num_sms(x.device)
    p, _ = _check_kernel_inputs(packed, a, w, x, lib, n_sms)
    out = torch.empty((p,), dtype=torch.float32, device=x.device)
    if p == 0:
        return out
    code = lib.fused_mlp_enc_fwd(
        x.data_ptr(), p, a.data_ptr(), w.data_ptr(), a.shape[0], packed.w_in.shape[1],
        packed.w_in.data_ptr(), packed.w_hid.data_ptr(), packed.bias.data_ptr(),
        packed.w_out.data_ptr(), packed.b_out.data_ptr(), packed.width, packed.n_hidden,
        out.data_ptr(), n_sms, torch.cuda.current_stream(x.device).cuda_stream,
    )
    raise_on(code, "fused_mlp_enc forward")
    enc_fwd_launches += 1
    return out


def fused_mlp_enc_bwd_cuda(packed: fm.PackedMLP, a, w, x: torch.Tensor, g: torch.Tensor):
    """Launch the backward (the chain with dx and the per-warp dA sums, the
    weight gradients, the fixed-order partial sums) over the tiles whose g
    is not all zero; returns what fused_mlp_enc_bwd_reference returns.
    Counts the launch, its tiles and points, and the chain adds the active
    tiles into ``fused_mlp.active_tiles(x.device)``."""
    global enc_bwd_launches, enc_bwd_tiles, enc_bwd_points
    lib = _load_lib()
    dev = x.device
    n_sms = _num_sms(dev)
    p, (_, stride, grad_n, mask_slots, quantum, da_n) = _check_kernel_inputs(
        packed, a, w, x, lib, n_sms)
    if g.shape != (p,) or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("g must be contiguous (P,) float32")
    f, nh, ke = packed.width, packed.n_hidden, packed.w_in.shape[1]
    rows = lib.fused_mlp_enc_scratch_rows(p)
    s = fm.BwdScratch.make(p, f, nh, n_sms, stride, mask_slots, quantum, dev, rows=rows)
    # the chain's stored features of the active tiles, read by dW_in
    feat = torch.empty((rows, ke), dtype=torch.bfloat16, device=dev)
    flat = torch.empty((grad_n,), dtype=torch.float32, device=dev)
    # the kernel skips 16-point tiles whose g is all zero: their dx stays 0
    dx = torch.zeros_like(x)
    da_slots = torch.empty((da_n,), dtype=torch.float32, device=dev)
    da = torch.empty((ke,), dtype=torch.float32, device=dev)
    code = lib.fused_mlp_enc_bwd(
        x.data_ptr(), g.data_ptr(), p, a.data_ptr(), w.data_ptr(), a.shape[0], ke,
        packed.w_in.data_ptr(), packed.w_hid.data_ptr(), packed.bias.data_ptr(),
        packed.w_out.data_ptr(), packed.b_out.data_ptr(), f, nh, *s.args(), n_sms,
        flat.data_ptr(), dx.data_ptr(), da_slots.data_ptr(), da.data_ptr(), feat.data_ptr(),
        fm.active_tiles(dev).data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(code, "fused_mlp_enc backward")
    enc_bwd_launches += 1
    enc_bwd_tiles += -(-p // 16)
    enc_bwd_points += p
    return fm._unflatten_grads(flat, f, nh, k_in=ke, rows=ke), da, dx


def fused_mlp_enc_fwd(packed: fm.PackedMLP, a, w, x: torch.Tensor) -> torch.Tensor:
    """Forward dispatch: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if x.device.type == "cuda":
        return fused_mlp_enc_fwd_cuda(packed, a, w, x)
    if x.device.type == "cpu":
        return fused_mlp_enc_fwd_reference(packed, a, w, x)
    raise ValueError(f"fused_mlp_enc: unsupported device {x.device}")


def fused_mlp_enc_bwd(packed: fm.PackedMLP, a, w, x: torch.Tensor, g: torch.Tensor):
    """Backward dispatch, as fused_mlp_enc_fwd."""
    if x.device.type == "cuda":
        return fused_mlp_enc_bwd_cuda(packed, a, w, x, g)
    if x.device.type == "cpu":
        return fused_mlp_enc_bwd_reference(packed, a, w, x, g)
    raise ValueError(f"fused_mlp_enc: unsupported device {x.device}")


def to_plist_grads(grads, da: torch.Tensor, kind: str, n_basis: int):
    """Kernel-layout gradients -> (the plist layout with dW_in (E, F) in
    the JAX feature order, dcoeff (3L,) for fourier or None), dcoeff_j = 2 pi
    (dA[sin j] + dA[cos j]) as the JAX ``_fused_enc_bwd`` forms it."""
    (dw_in, db_in), *rest = grads
    out = [(dw_in[kernel_columns(n_basis, dw_in.device)], db_in), *rest]
    if kind != "fourier":
        return out, None
    n = 3 * n_basis
    return out, 2.0 * math.pi * (da[4 : 4 + 2 * n : 2] + da[5 : 5 + 2 * n : 2])


class FusedMLPEncRaw(torch.autograd.Function):
    """raw = MLP(encode(x)) with the fused kernels (custom backward = kernel
    #4 on the card). Inputs: x (P, 3), spec = (kind, L), the encoding's
    tensor (the fourier coefficients, or the BARF window), then the
    flattened plist [W_in (E, F), b_in, W_0, b_0, ..., w_out, b_out];
    returns gradients for x, the fourier coefficients (None for the BARF
    window: a schedule, as JAX returns zeros for it) and every parameter."""

    @staticmethod
    def forward(ctx, x, spec, enc, *flat):
        kind, n_basis = spec
        plist = list(zip(flat[0::2], flat[1::2]))
        packed = pack_enc_params(plist, n_basis)
        a, w = enc_arrays(kind, n_basis, enc.detach())
        x = x.detach().to(torch.float32).contiguous()
        ctx.packed, ctx.a, ctx.w, ctx.spec = packed, a.contiguous(), w.contiguous(), spec
        ctx.shapes = [(t.shape, t.dtype) for t in flat]
        ctx.enc_dtype = enc.dtype
        ctx.save_for_backward(x)
        return fused_mlp_enc_fwd(packed, ctx.a, ctx.w, x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        kind, n_basis = ctx.spec
        with annotate("step/mlp_bwd"):
            grads, da, dx = fused_mlp_enc_bwd(
                ctx.packed, ctx.a, ctx.w, x, g.to(torch.float32).contiguous()
            )
        grads, dcoeff = to_plist_grads(grads, da, kind, n_basis)
        flat = [t for pair in grads for t in pair]
        out = [t.reshape(s).to(dt) for t, (s, dt) in zip(flat, ctx.shapes)]
        denc = None if dcoeff is None else dcoeff.to(ctx.enc_dtype)
        return (dx, None, denc, *out)


def fused_mlp_enc_raw(spec, plist, enc_params: dict, x: torch.Tensor) -> torch.Tensor:
    """Fused encoded MLP: x (P, 3) f32 -> raw density (P,) f32, the JAX
    ``fused_mlp_enc_raw`` signature: spec = ('fourier' | 'barf', L),
    ``plist`` as fused_mlp_raw's with W_in (3 + 6L, F), ``enc_params`` =
    {'coeff': (3L,)} (fourier, differentiable) or {'w': (3L,)} (the BARF
    window at the current alpha, not differentiated)."""
    kind, n_basis = spec
    enc = enc_params["coeff"] if kind == "fourier" else enc_params["w"]
    flat = [t for pair in plist for t in pair]
    return FusedMLPEncRaw.apply(x, (kind, int(n_basis)), enc, *flat)
