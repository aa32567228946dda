"""Fused CPPN-MLP forward/backward: hand-written Hopper kernels and their
plain PyTorch versions.

Replaces the TPU kernels ``nerf_for_angiography_tpu/ops/pallas/fused_mlp.py``
``_fwd_kernel`` (line 142) and ``_bwd_kernel`` (line 160). The CUDA C++
source is ``csrc/fused_mlp.cu`` (sm_90a, bf16 tensor cores with f32
accumulators, the layer chain in registers): the forward is the warpgroup
MMA kernel of ``csrc/mlp_wgmma.cuh`` (wgmma, 64-point tiles a warpgroup,
every weight in shared memory in wgmma's layouts), the backward the
kernel of ``csrc/mlp_onchip.cuh`` at F = 64 and 128 (thread-block
clusters, one block a hidden layer, every weight gradient of a chunk kept in
registers, no activation or dz in device memory), at the other widths the
two-kernel ``mma.sync`` chain of ``csrc/mlp_chain.cuh``, which takes 2 x
(n_hidden + 1) x P x F bf16 of scratch for the activations and dz (P rounded
up to whole 16-point tiles); the headers state the bound and the design.
The library says which a shape takes (``fused_mlp_bwd_onchip``). Both work
only on tiles whose upstream gradient g is not all zero: the others add
exact zeros to every gradient, and their dx stays 0.

The kernels read x through its strides: point-major (P, 3) as
``fused_mlp_raw`` passes it, or feature-major (3, P) as ``fused_mlp_raw_fm``
does (the JAX ``fused_mlp_raw_fm``'s input without its five pad rows), and
write dx in the layout of x.

Bound at the flagship shapes (F = 128, n_hidden = 4): 132,096 FLOP per point
forward and about three times that backward, against 16 bytes of point
input/output, so every call is compute-bound on the bf16 tensor cores.

Both versions compute the same function at the same cast points as the TPU
kernel: x and W rounded to bf16 before each product, f32 accumulation, f32
bias + relu, bf16 activations, an f32 head dot with w_out plus b_out; in
backward dh rounds to bf16, the relu mask comes from the recomputed bf16
activations, dW/db accumulate in f32 and dx is f32.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel (building it with ``nvcc`` on first use) or raises.
There is no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from ...utils.profiling import annotate
from .build import load_library, raise_on

# launches of each kernel since the last reset (the wrappers add one per
# launch and nowhere else), the backward's launches that ran on chip, and
# its launched 16-point tiles (ceil(P / 16) a launch) and points
fwd_launches = 0
bwd_launches = 0
bwd_onchip = 0
bwd_tiles = 0
bwd_points = 0
# a device int64 per card: the active tiles the backward's chain processed
# (it adds into it on the card, launch after launch and replay after replay;
# the encoded backward, kernel #4, adds into it too)
_active_tiles: dict = {}

_KIN = 16  # input features (3 coords) padded to one mma k-step
_lib = None
_lib_lock = threading.Lock()
# nvcc's output of the last build (ptxas register/shared-memory report)
build_log = ""


def reset_counts() -> None:
    global fwd_launches, bwd_launches, bwd_onchip, bwd_tiles, bwd_points
    fwd_launches = 0
    bwd_launches = 0
    bwd_onchip = 0
    bwd_tiles = 0
    bwd_points = 0


def active_tiles(device: torch.device) -> torch.Tensor:
    """The card's (1,) int64 count of the active tiles kernels #2 and #4
    have processed (it never resets: read it before and after). Made on first
    use, which must come before any CUDA graph capture (the loop reads it
    as a job starts; a chunk's eager warm-up step launches the kernel
    before its capture)."""
    key = torch.device(device).index
    key = torch.cuda.current_device() if key is None else key
    t = _active_tiles.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("kernel #2's tile counter must exist before a CUDA graph capture")
        t = _active_tiles[key] = torch.zeros((1,), dtype=torch.int64,
                                             device=torch.device("cuda", key))
    return t


class PackedMLP(NamedTuple):
    """Kernel-side parameter layout, weights in (out, in) orientation as
    nn.Linear holds them: w_in (F, 16) bf16 with inputs 3..15 zero, w_hid
    (n_hidden, F, F) bf16, bias (n_hidden + 1, F) f32, w_out (F,) f32,
    b_out (1,) f32."""

    w_in: torch.Tensor
    w_hid: torch.Tensor
    bias: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor

    @property
    def width(self) -> int:
        return self.w_in.shape[0]

    @property
    def n_hidden(self) -> int:
        return self.w_hid.shape[0]


def pack_params(plist) -> PackedMLP:
    """[(W_in (3,F), b_in), (W (F,F), b)..., (w_out (F,1), b_out (1,))] ->
    PackedMLP. The same list layout as the JAX ``fused_mlp_raw`` takes."""
    (w_in, b_in), *hidden, (w_out, b_out) = plist
    f = w_in.shape[1]
    dev = w_in.device
    w_in_p = torch.zeros((f, _KIN), dtype=torch.bfloat16, device=dev)
    w_in_p[:, :3] = w_in.detach().T.to(torch.bfloat16)
    if hidden:
        w_hid = torch.stack([w.detach().T for w, _ in hidden]).to(torch.bfloat16)
    else:
        w_hid = torch.zeros((0, f, f), dtype=torch.bfloat16, device=dev)
    bias = torch.stack(
        [b_in.detach().reshape(f)] + [b.detach().reshape(f) for _, b in hidden]
    ).to(torch.float32)
    return PackedMLP(
        w_in=w_in_p,
        w_hid=w_hid.contiguous(),
        bias=bias.contiguous(),
        w_out=w_out.detach().reshape(f).to(torch.float32).contiguous(),
        b_out=b_out.detach().reshape(1).to(torch.float32).contiguous(),
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the card-side yardstick)
# ---------------------------------------------------------------------------


def _point_major(x: torch.Tensor, feature_major: bool) -> torch.Tensor:
    return x.T if feature_major else x


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _forward_acts(packed: PackedMLP, x: torch.Tensor):
    """bf16-rounded input (P, n_in) and the bf16 activations of every layer
    (n_in = 3 coordinates, or an encoded input as wide as w_in)."""
    xb = _bf(x)
    h = torch.relu(xb @ packed.w_in[:, : xb.shape[1]].float().T + packed.bias[0])
    acts = [h.to(torch.bfloat16)]
    for li in range(packed.n_hidden):
        z = acts[-1].float() @ packed.w_hid[li].float().T + packed.bias[li + 1]
        acts.append(torch.relu(z).to(torch.bfloat16))
    return xb, acts


def _head(packed: PackedMLP, acts) -> torch.Tensor:
    """raw = bf16 last activation . w_out + b_out, in f32."""
    return (acts[-1].float() * packed.w_out).sum(-1) + packed.b_out[0]


def fused_mlp_fwd_reference(
    packed: PackedMLP, x: torch.Tensor, feature_major: bool = False
) -> torch.Tensor:
    """x (P, 3) f32, or (3, P) with ``feature_major`` -> raw density (P,)
    f32, plain PyTorch."""
    _, acts = _forward_acts(packed, _point_major(x, feature_major))
    return _head(packed, acts)


def fused_mlp_bwd_reference(
    packed: PackedMLP, x: torch.Tensor, g: torch.Tensor, feature_major: bool = False
):
    """Backward of fused_mlp_fwd_reference for dL/draw = g (P,).

    Returns (grads, dx): grads in the plist layout [(dW_in (3,F), db_in),
    (dW (F,F), db)..., (dw_out (F,1), db_out (1,))], dx f32 in the layout of
    x."""
    xb, acts = _forward_acts(packed, _point_major(x, feature_major))
    grads, dzf = backward_from_acts(packed, xb, acts, g)
    dx = dzf @ packed.w_in[:, :3].float()
    return grads, _point_major(dx, feature_major).contiguous()


def backward_from_acts(packed: PackedMLP, xb: torch.Tensor, acts, g: torch.Tensor):
    """The parameter gradients of the MLP for dL/draw = g (P,) from the
    bf16 input xb (P, n_in) and the bf16 activations of _forward_acts. Returns
    (grads in the plist layout, the input layer's dz (P, F) f32)."""
    g = g.float()
    f = packed.width
    dw_out = acts[-1].float().T @ g
    db_out = g.sum().reshape(1)
    dh = (g[:, None] * packed.w_out[None, :]).to(torch.bfloat16)
    hidden = [None] * packed.n_hidden
    for li in range(packed.n_hidden - 1, -1, -1):
        dz = dh * (acts[li + 1].float() > 0).to(torch.bfloat16)
        dzf = dz.float()
        hidden[li] = (acts[li].float().T @ dzf, dzf.sum(0))
        dh = (dzf @ packed.w_hid[li].float()).to(torch.bfloat16)
    dzf = (dh * (acts[0].float() > 0).to(torch.bfloat16)).float()
    grads = [(xb.T @ dzf, dzf.sum(0))] + hidden
    grads.append((dw_out.reshape(f, 1), db_out))
    return grads, dzf


# ---------------------------------------------------------------------------
# the CUDA kernels: build on first use, bind with ctypes
# ---------------------------------------------------------------------------


def _load_lib() -> ctypes.CDLL:
    """Build csrc/fused_mlp.cu on first use (ops/kernels/build.py) and bind
    its C interface."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = load_library("fused_mlp")
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for name in ("fused_mlp_smem_bytes", "fused_mlp_partial_stride", "fused_mlp_grad_size",
                     "fused_mlp_mask_slots"):
            getattr(lib, name).argtypes = [i32, i32]
            getattr(lib, name).restype = ll
        lib.fused_mlp_fwd.argtypes = [vp, ll, ll, ll, vp, vp, vp, vp, vp, i32, i32, vp, i32, vp]
        lib.fused_mlp_fwd.restype = i32
        lib.fused_mlp_chunk_quantum.argtypes = []
        lib.fused_mlp_chunk_quantum.restype = i32
        lib.fused_mlp_bwd.argtypes = [
            vp, ll, ll, vp, ll, vp, vp, vp, vp, vp, i32, i32, vp, vp, vp, vp, i32, ll, i32, vp, vp,
            vp, vp,
        ]
        lib.fused_mlp_bwd.restype = i32
        lib.fused_mlp_scratch_rows.argtypes = [ll]
        lib.fused_mlp_scratch_rows.restype = ll
        lib.fused_mlp_bwd_onchip.argtypes = [i32, i32]
        lib.fused_mlp_bwd_onchip.restype = i32
        _lib = lib
        return lib


# largest dynamic shared memory a block may use on Hopper
_MAX_SMEM = 232_448


def check_packed(packed: PackedMLP, device: torch.device, smem: int) -> None:
    """Raise on parameters the kernels do not take: off ``device``, not
    contiguous, an unsupported width (``smem`` 0) or weights beyond
    shared memory."""
    f, nh = packed.width, packed.n_hidden
    for t in packed:
        if t.device != device or not t.is_contiguous():
            raise ValueError("packed parameters must be contiguous on x's device")
    if smem == 0:
        raise ValueError(f"fused-MLP kernel needs 16 <= F <= 128, F % 16 == 0; got F={f}")
    if smem > _MAX_SMEM:
        raise ValueError(
            f"fused-MLP kernels keep every weight in shared memory: {smem} B at F={f}, "
            f"n_hidden={nh} (Hopper allows {_MAX_SMEM})"
        )


def _check_kernel_inputs(packed: PackedMLP, x: torch.Tensor, lib, feature_major: bool):
    """Raise on inputs the kernels do not take; returns (P, the point
    stride, the coordinate stride) of x."""
    p = x.shape[-1] if feature_major else x.shape[0]
    shape = (3, p) if feature_major else (p, 3)
    if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
        want = "(3, P)" if feature_major else "(P, 3)"
        raise ValueError(f"x must be contiguous {want} float32, got {tuple(x.shape)} {x.dtype}")
    check_packed(packed, x.device, lib.fused_mlp_smem_bytes(packed.width, packed.n_hidden))
    return (p, 1, p) if feature_major else (p, 3, 1)


def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class BwdScratch(NamedTuple):
    """The backward's device scratch: every layer's bf16 activation and dz
    ((n_hidden + 1, P, F) each), the relu-mask slots (8 bytes each) and the
    f32 partials of the weight-gradient chunks (about one chunk per SM, each
    a multiple of the kernel's pipeline stage). The on-chip backward takes
    the partials alone (``scratch=False``: acts, dzs and masks empty)."""

    acts: torch.Tensor
    dzs: torch.Tensor
    masks: torch.Tensor
    partials: torch.Tensor
    n_chunks: int
    chunk: int

    @staticmethod
    def make(p, f, nh, n_sms, stride, mask_slots, quantum, dev, rows=None,
             scratch=True) -> "BwdScratch":
        """``rows``: rows of each layer block of acts/dzs (default p)."""
        chunk = max(1, -(-p // (n_sms * quantum))) * quantum
        n_chunks = -(-p // chunk)
        rows = (p if rows is None else rows) if scratch else 0
        return BwdScratch(
            acts=torch.empty((nh + 1, rows, f), dtype=torch.bfloat16, device=dev),
            dzs=torch.empty((nh + 1, rows, f), dtype=torch.bfloat16, device=dev),
            masks=torch.empty((mask_slots if scratch else 0,), dtype=torch.int64, device=dev),
            partials=torch.empty((max(n_chunks, 1) * stride,), dtype=torch.float32, device=dev),
            n_chunks=n_chunks,
            chunk=chunk,
        )

    def args(self) -> tuple:
        """(acts, dzs, masks, partials, n_chunks, chunk) as the C functions
        take them."""
        return (self.acts.data_ptr(), self.dzs.data_ptr(), self.masks.data_ptr(),
                self.partials.data_ptr(), self.n_chunks, self.chunk)


def fused_mlp_fwd_cuda(
    packed: PackedMLP, x: torch.Tensor, feature_major: bool = False
) -> torch.Tensor:
    """Launch the forward kernel: x (P, 3) f32 on the card, or (3, P) with
    ``feature_major`` -> (P,) f32."""
    global fwd_launches
    lib = _load_lib()
    p, sp, sc = _check_kernel_inputs(packed, x, lib, feature_major)
    out = torch.empty((p,), dtype=torch.float32, device=x.device)
    if p == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.fused_mlp_fwd(
        x.data_ptr(), sp, sc, p, packed.w_in.data_ptr(), packed.w_hid.data_ptr(),
        packed.bias.data_ptr(), packed.w_out.data_ptr(), packed.b_out.data_ptr(),
        packed.width, packed.n_hidden, out.data_ptr(), _num_sms(x.device), stream,
    )
    raise_on(code, "fused_mlp forward")
    fwd_launches += 1
    return out


def fused_mlp_bwd_cuda(
    packed: PackedMLP, x: torch.Tensor, g: torch.Tensor, feature_major: bool = False
):
    """Launch the backward kernel (+ its fixed-order partial reduction); dx
    comes back in the layout of x. Counts the launch (and, where it ran on
    chip, ``bwd_onchip``), its tiles and points, and the kernel adds the
    active tiles into ``active_tiles(x.device)``."""
    global bwd_launches, bwd_onchip, bwd_tiles, bwd_points
    lib = _load_lib()
    p, sp, sc = _check_kernel_inputs(packed, x, lib, feature_major)
    if g.shape != (p,) or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("g must be contiguous (P,) float32")
    f, nh = packed.width, packed.n_hidden
    dev = x.device
    n_sms = _num_sms(dev)
    onchip = bool(lib.fused_mlp_bwd_onchip(f, nh))
    s = BwdScratch.make(
        p, f, nh, n_sms, lib.fused_mlp_partial_stride(f, nh),
        lib.fused_mlp_mask_slots(n_sms, nh), lib.fused_mlp_chunk_quantum(), dev,
        rows=lib.fused_mlp_scratch_rows(p), scratch=not onchip,
    )
    flat = torch.empty((lib.fused_mlp_grad_size(f, nh),), dtype=torch.float32, device=dev)
    # the kernel skips 16-point tiles whose g is all zero: their dx stays 0
    dx = torch.zeros_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.fused_mlp_bwd(
        x.data_ptr(), sp, sc, g.data_ptr(), p, packed.w_in.data_ptr(), packed.w_hid.data_ptr(),
        packed.bias.data_ptr(), packed.w_out.data_ptr(), packed.b_out.data_ptr(),
        f, nh, *s.args(), n_sms, flat.data_ptr(), dx.data_ptr(), active_tiles(dev).data_ptr(),
        stream,
    )
    raise_on(code, "fused_mlp backward")
    bwd_launches += 1
    bwd_onchip += onchip
    bwd_tiles += -(-p // 16)
    bwd_points += p
    return _unflatten_grads(flat, f, nh), dx


def _unflatten_grads(flat: torch.Tensor, f: int, nh: int, k_in: int = _KIN, rows: int = 3):
    """Flat kernel gradient -> the plist layout (see csrc GradLayout): dW_in
    is the first ``rows`` of the kernel's (k_in, F) block."""
    o = 0
    dw_in = flat[o : o + k_in * f].view(k_in, f)[:rows]
    o += k_in * f
    dw_hid = flat[o : o + nh * f * f].view(nh, f, f)
    o += nh * f * f
    db = flat[o : o + (nh + 1) * f].view(nh + 1, f)
    o += (nh + 1) * f
    dw_out = flat[o : o + f].view(f, 1)
    db_out = flat[o + f : o + f + 1]
    return (
        [(dw_in, db[0])]
        + [(dw_hid[li], db[li + 1]) for li in range(nh)]
        + [(dw_out, db_out)]
    )


def fused_mlp_fwd(
    packed: PackedMLP, x: torch.Tensor, feature_major: bool = False
) -> torch.Tensor:
    """Forward dispatch: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if x.device.type == "cuda":
        return fused_mlp_fwd_cuda(packed, x, feature_major)
    if x.device.type == "cpu":
        return fused_mlp_fwd_reference(packed, x, feature_major)
    raise ValueError(f"fused_mlp: unsupported device {x.device}")


def fused_mlp_bwd(
    packed: PackedMLP, x: torch.Tensor, g: torch.Tensor, feature_major: bool = False
):
    """Backward dispatch, as fused_mlp_fwd."""
    if x.device.type == "cuda":
        return fused_mlp_bwd_cuda(packed, x, g, feature_major)
    if x.device.type == "cpu":
        return fused_mlp_bwd_reference(packed, x, g, feature_major)
    raise ValueError(f"fused_mlp: unsupported device {x.device}")


class FusedMLPRaw(torch.autograd.Function):
    """raw = MLP(x) with the fused kernels (custom backward = kernel #2 on
    the card). Inputs: x ((P, 3), or (3, P) with ``feature_major``), the
    layout flag, then the flattened plist [W_in, b_in, W_0, b_0, ..., w_out,
    b_out] (W in (in, out) orientation); returns gradients for x and every
    parameter."""

    @staticmethod
    def forward(ctx, x, feature_major, *flat):
        plist = list(zip(flat[0::2], flat[1::2]))
        packed = pack_params(plist)
        x = x.detach().to(torch.float32).contiguous()
        ctx.packed = packed
        ctx.feature_major = feature_major
        ctx.shapes = [(t.shape, t.dtype) for t in flat]
        ctx.save_for_backward(x)
        return fused_mlp_fwd(packed, x, feature_major)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with annotate("step/mlp_bwd"):
            grads, dx = fused_mlp_bwd(
                ctx.packed, x, g.to(torch.float32).contiguous(), ctx.feature_major
            )
        flat = [t for pair in grads for t in pair]
        out = [t.reshape(s).to(dt) for t, (s, dt) in zip(flat, ctx.shapes)]
        return (dx, None, *out)


def fused_mlp_raw(plist, x: torch.Tensor) -> torch.Tensor:
    """Fused MLP: x (P, 3) f32 -> raw density (P,) f32, differentiable in x
    and every parameter of ``plist`` (layout of pack_params)."""
    flat = [t for pair in plist for t in pair]
    return FusedMLPRaw.apply(x, False, *flat)


def fused_mlp_raw_fm(plist, x_fm: torch.Tensor) -> torch.Tensor:
    """Feature-major fused MLP: x_fm (3, P) f32 -> raw density (P,) f32, as
    fused_mlp_raw; the kernels read the (3, P) block as it is (no relayout)
    and its gradient comes back (3, P)."""
    flat = [t for pair in plist for t in pair]
    return FusedMLPRaw.apply(x_fm, True, *flat)


def cppn_params_to_list(model) -> list:
    """The fused-kernel parameter list of a port CPPN module (its linears()
    in kernel order), weights as (in, out) views; a layer without a bias
    (``use_bias=False``) takes a zero one."""
    return [(lin.weight.T, lin.bias if lin.bias is not None
             else torch.zeros(lin.out_features, device=lin.weight.device))
            for lin in model.linears()]
