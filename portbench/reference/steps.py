"""Plain PyTorch reference of the first training steps of a reconstruction.

It imports nothing of the port. From the seed, the benchmark's dataset and
the cell's settings it works out again what the port derives: the CPPN's
initial weights, the weighted overdraw sampling table and the batches it
draws, the space carve, the step-0 grid update, and then follows the steps
themselves: the dense lattice march with the strided occupancy probe, the
relu MLP, the early-stop keep mask, the Beer-Lambert composite, the MSE and
Adam with the exponentially decaying lr (AdamW with a second group for the
view shifts of pose refinement). Everything is float32 with TF32 off.

The port's compacted march keeps the first k active samples of each ray;
the reference marches the whole lattice. The two renders are the same as
long as k covers every sample the early-stop keep mask lets through, which
holds at the start of training (a sample's transmittance falls below
``early_stop_eps`` after a few tens of active samples). So the reference
holds the compacted steps to the lossless render.

``quant`` swaps the MLP's matmul operands for per-tensor scaled float8
(e4m3) ones, in the forward and in the backward: the control, one precision
below the bfloat16 operands the configuration states.

The positional encoding is a module of its own, picked by the ``pos_enc``
setting (portbench/reference/encodings/); its learnable leaves (the Fourier
coefficients) are drawn and trained with the MLP's. Settings the reference
does not follow are listed by ``unmodelled``, and a cell that has one is
refused.
"""

from __future__ import annotations

import importlib
import math
import os
from typing import Callable

import numpy as np
import torch

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8
# the training settings whose other values the reference does not follow
MODELLED = {
    "binary": (False,), "sample_mode": ("pixel",), "sampling_impl": ("overdraw",),
    "sampling_strategy": ("frangi",), "train_alpha_prune": (False,),
    "grid_jitter": (False,), "num_input_channels_views": (0,),
}
ENCODINGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "encodings")


def unmodelled(train: dict) -> list[str]:
    """The cell's settings that the reference does not follow (empty when
    it follows them all); a setting left out of ``train`` counts."""
    out = [f"{k}={train.get(k, 'unset')!r} (follows {list(v)})" for k, v in MODELLED.items()
           if train.get(k, "unset") not in v]
    enc = train.get("pos_enc", "unset")
    if not os.path.exists(os.path.join(ENCODINGS, f"{enc}.py")):
        out.append(f"pos_enc={enc!r} (no portbench/reference/encodings/{enc}.py)")
    return out


def encoding(name: str):
    """The reference's module for the positional encoding ``name``."""
    return importlib.import_module(f"{__package__}.encodings.{name}")


# ---------------------------------------------------------------------------
# weights and the MLP
# ---------------------------------------------------------------------------


def init_weights(seed: int, widths: list[int], device, enc,
                 train: dict) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """([W_0, b_0, W_1, b_1, ...] (W as (out, in)), the encoding's leaves):
    flax's lecun_normal, a normal truncated at two standard deviations with
    variance 1/fan_in, drawn on the CPU from one generator seeded with
    ``seed``, layer by layer; zero biases; then the leaves of the encoding
    module ``enc`` (``enc.leaves``) from the same generator."""
    gen = torch.Generator().manual_seed(int(seed))
    leaves = []
    for fan_in, fan_out in zip(widths[:-1], widths[1:]):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w = torch.empty((fan_out, fan_in), dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2 * std, b=2 * std, generator=gen)
        leaves += [w.to(device), torch.zeros(fan_out, dtype=torch.float32, device=device)]
    return leaves, [t.to(device) for t in enc.leaves(gen, train)]


def fp8_quant(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 rounding of a float32 tensor."""
    amax = t.detach().abs().amax()
    if amax == 0:
        return t
    s = 448.0 / amax
    return (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class _QuantLinear(torch.autograd.Function):
    """h @ W.T + b with both operands rounded by ``q``; the backward rounds
    the upstream gradient and the saved operands the same way."""

    @staticmethod
    def forward(ctx, h, w, b, q):
        hq, wq = q(h), q(w)
        ctx.save_for_backward(hq, wq)
        ctx.q = q
        return hq @ wq.T + b

    @staticmethod
    def backward(ctx, g):
        hq, wq = ctx.saved_tensors
        gq = ctx.q(g)
        return gq @ wq, gq.T @ hq, g.sum(0), None


def mlp_raw(leaves: list[torch.Tensor], x: torch.Tensor, quant: Callable | None = None):
    """Raw density of the relu MLP at (P, 3) scaled positions -> (P,)."""
    n = len(leaves) // 2
    h = x
    for i in range(n):
        w, b = leaves[2 * i], leaves[2 * i + 1]
        h = (torch.nn.functional.linear(h, w, b) if quant is None
             else _QuantLinear.apply(h, w, b, quant))
        if i < n - 1:
            h = torch.relu(h)
    return h[:, 0]


def sigma_at(leaves, pts: torch.Tensor, input_scale: float, encode: Callable, quant=None,
             chunk: int = 1 << 18) -> torch.Tensor:
    """sigmoid(raw) at world points (P, 3), without gradients, in chunks."""
    with torch.no_grad():
        return torch.cat([torch.sigmoid(mlp_raw(leaves, encode(pts[s:s + chunk] * input_scale),
                                                quant))
                          for s in range(0, pts.shape[0], chunk)])


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def sampling_table(weights: torch.Tensor, table_size: int = 1 << 18) -> torch.Tensor:
    """table[j] = the smallest ray i with cdf[i] >= (j + 0.5) / table_size;
    the cdf a sequential float32 sum in ray order."""
    w = weights.detach().to("cpu", torch.float32).numpy()
    cdf = torch.from_numpy(np.cumsum(w, dtype=np.float32)).to(weights.device)
    cdf = cdf / cdf[-1]
    u = (torch.arange(table_size, dtype=torch.float32, device=weights.device) + 0.5) / table_size
    return torch.searchsorted(cdf, u)


def overdraw_rows(gen: torch.Generator, table: torch.Tensor, n: int, n_rays: int,
                  oversample: float = 1.125) -> torch.Tensor:
    """n ray rows: ceil(n * oversample) uniform table slots mapped through
    the table, the first n distinct rows in draw order, then (if too few are
    distinct) the earliest repeats in draw order."""
    m = int(math.ceil(n * oversample))
    draws = torch.randint(0, table.shape[0], (m,), generator=gen, device=table.device)
    idx = table[draws].cpu().numpy()
    seen: set[int] = set()
    uniq, dup = [], []
    for i in idx.tolist():
        (dup if i in seen else uniq).append(i)
        seen.add(i)
    rows = (uniq + dup)[:n]
    assert max(rows) < n_rays
    return torch.tensor(rows, dtype=torch.int64, device=table.device)


# ---------------------------------------------------------------------------
# the occupancy grid
# ---------------------------------------------------------------------------


def dilate3(x: torch.Tensor) -> torch.Tensor:
    """3x3x3 binary dilation, same size."""
    p = torch.nn.functional.pad(x.to(torch.float32)[None, None], (1, 1, 1, 1, 1, 1))
    return torch.nn.functional.max_pool3d(p, 3, stride=1)[0, 0] > 0


def cell_index(pos: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, res: int):
    """(flat cell index, inside the box) of world points (..., 3)."""
    inside = ((pos >= lo) & (pos <= hi)).all(dim=-1)
    idx = torch.clamp(((pos - lo) / (hi - lo) * res).to(torch.int64), 0, res - 1)
    return (idx[..., 0] * res + idx[..., 1]) * res + idx[..., 2], inside


def carve(origins, directions, pixels, aabb: torch.Tensor, res: int, near: float, far: float,
          thresh: float, samples_per_cell: float = 2.0, chunk: int = 8192) -> torch.Tensor:
    """Space carving: every cell a ray of pixel >= thresh passes through
    (samples at twice the cell rate) is empty; the empty set eroded by one
    cell. Returns the feasible (not provably empty) cells, bool (res,)*3."""
    lo, hi = aabb[:3], aabb[3:]
    cell = float((hi - lo).max()) / res
    n_s = int(np.ceil((far - near) / (cell / samples_per_cell)))
    n_s = max(8, min(n_s, 4 * res * int(np.ceil(samples_per_cell))))
    ts = near + (torch.arange(n_s, dtype=torch.float32, device=aabb.device) + 0.5) * (
        (far - near) / n_s)
    carved = torch.zeros(res ** 3, dtype=torch.bool, device=aabb.device)
    white = pixels >= thresh
    for s in range(0, origins.shape[0], chunk):
        o, d, w = origins[s:s + chunk], directions[s:s + chunk], white[s:s + chunk]
        flat, inside = cell_index(o[:, None, :] + d[:, None, :] * ts[None, :, None], lo, hi, res)
        carved[flat[w[:, None] & inside]] = True
    return dilate3(~carved.reshape(res, res, res))


def cell_centers(aabb: torch.Tensor, res: int) -> torch.Tensor:
    c = (torch.arange(res, dtype=torch.float32, device=aabb.device) + 0.5) / res
    axes = [aabb[a] + c * (aabb[a + 3] - aabb[a]) for a in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)


def dense_grid_update(occs, feasible, leaves, aabb, res, thre, ema, input_scale, encode,
                      quant=None):
    """The EMA update of every cell from sigma at its center: occs <-
    max(occs * ema, sigma), binary = occs > min(mean(occs), thre), within
    the feasible cells. Returns (occs, binary)."""
    sigma = sigma_at(leaves, cell_centers(aabb, res), input_scale, encode, quant).reshape(
        occs.shape)
    occs = torch.maximum(occs * ema, sigma)
    binary = occs > torch.clamp(occs.mean(), max=thre)
    return occs, (binary if feasible is None else binary & feasible)


def safe_stride(stride: int, n_samples: int, near: float, far: float, extent: float,
                res: int) -> int:
    """The largest probe stride <= ``stride`` whose spacing stays below a cell."""
    step = (far - near) / n_samples
    safe = max(1, stride)
    while safe > 1 and safe * step >= extent / res:
        safe -= 1
    return safe


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------


def render(leaves, binary, aabb, origins, directions, near, far, n_samples, stride,
           early_stop_eps, input_scale, encode, quant=None) -> torch.Tensor:
    """Pixels of the dense lattice march: samples at segment midpoints,
    inside the box and in an occupied cell (probed every ``stride``-th
    sample, a sample occupied if either bracketing probe is), composited
    as exp(-sum sigma * keep * step) with keep the early-stop mask of the
    detached densities."""
    res = binary.shape[0]
    step = (far - near) / n_samples
    i = torch.arange(n_samples, dtype=torch.float32, device=origins.device)
    t0 = near + i * step
    t_mid = (t0 + (t0 + step)) / 2.0
    pos = origins[:, None, :] + directions[:, None, :] * t_mid[None, :, None]
    lo, hi = aabb[:3], aabb[3:]
    d = torch.where(directions.abs() < 1e-10, torch.full_like(directions, 1e-10), directions)
    ta, tb = (lo - origins) / d, (hi - origins) / d
    t_in = torch.minimum(ta, tb).amax(-1, keepdim=True)
    t_out = torch.maximum(ta, tb).amin(-1, keepdim=True)
    in_box = (t_mid >= t_in) & (t_mid <= t_out)

    def occ(p):
        flat, inside = cell_index(p, lo, hi, res)
        return binary.reshape(-1)[flat] & inside

    if stride <= 1:
        occupied = occ(pos)
    else:
        probe = occ(pos[:, ::stride, :])
        left = probe.repeat_interleave(stride, dim=-1)[:, :n_samples]
        nxt = torch.cat([probe[:, 1:], probe[:, -1:]], dim=-1)
        occupied = left | nxt.repeat_interleave(stride, dim=-1)[:, :n_samples]
    mask = (in_box & occupied).to(torch.float32)
    sigma = torch.sigmoid(mlp_raw(leaves, encode(pos.reshape(-1, 3) * input_scale),
                                  quant)).reshape(mask.shape)
    dists = (t0 + step) - t0
    tau = sigma.detach() * dists * mask
    keep = mask * (torch.exp(-(torch.cumsum(tau, -1) - tau)) >= early_stop_eps).to(torch.float32)
    return torch.exp(-(sigma * keep * dists).sum(-1))


def lr_at(lr0: float, rate: float, steps: int, count: int, device) -> torch.Tensor:
    """lr0 * rate^(count / steps) in float32."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return f32(lr0) * torch.pow(f32(rate), f32(float(count)) / f32(float(steps)))


def adam_update(p, g, m, v, t: int, lr, weight_decay: float = 0.0) -> None:
    """One Adam(W) update in place: decoupled decay p *= 1 - lr wd, then
    p -= lr m_hat / (sqrt(v_hat) + eps)."""
    if weight_decay:
        p.mul_(1 - lr * weight_decay)
    m.mul_(BETA1).add_(g, alpha=1 - BETA1)
    v.mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
    denom = v.sqrt() / math.sqrt(1 - BETA2 ** t) + ADAM_EPS
    p.sub_(lr / (1 - BETA1 ** t) * m / denom)


def follow(spec: dict, rays: dict, seed: int, n_steps: int = 3, quant=None) -> dict:
    """The first ``n_steps`` steps of a reconstruction, from the seed.

    ``rays``: the benchmark's dataset (origins, directions, pixel_values,
    weights, image_ids as tensors on the device), views of ``rays_per_view``
    rays each, the last view held out. ``spec``: the cell's settings (see
    portbench/check.py::reference_spec). Returns the initial weights, the
    feasible cells, the grid after step 0, and for every step its batch's
    targets, its loss and, after step 0, the gradient; the leaves after the
    last step, and each step's rendered pixels. Leaves: the MLP's (W, b) in
    layer order, then the encoding's leaves (portbench/reference/encodings/),
    then the view shifts under pose refinement (``shifts`` True). The
    encoding's leaves train in the MLP's Adam group; its grid updates read
    their current values, detached."""
    dev = rays["origins"].device
    keep_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(spec, rays, seed, n_steps, quant, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep_tf32


def _follow(spec, rays, seed, n_steps, quant, dev) -> dict:
    n_views = int(rays["image_ids"].max()) + 1
    rpv = rays["origins"].shape[0] // n_views
    test = (n_views - 1) * rpv
    train = {k: v[:test] for k, v in rays.items()}  # the held-out view is the last
    near, far = spec["src_pt_z"] - spec["outside"], spec["src_pt_z"] + spec["outside"]
    out = spec["outside"]
    aabb = torch.tensor([-out] * 3 + [out] * 3, dtype=torch.float32, device=dev)
    res, n = spec["grid_resolution"], spec["depth_samples_per_ray"]
    stride = safe_stride(spec["occ_stride"], n, near, far, 2 * out, res)
    scale = 1.0 / out
    enc = encoding(spec["pos_enc"])
    mlp, enc_leaves = init_weights(seed, spec["widths"], dev, enc, spec["train"])
    leaves = [t.requires_grad_(True) for t in mlp + enc_leaves]
    mlp, enc_leaves = leaves[:len(mlp)], leaves[len(mlp):]

    def encoder(values, step):
        """The MLP's input at step ``step``, the encoding's leaves at ``values``."""
        return lambda x: enc.encode(x, values, step, spec["train"])

    pose = spec["pose_refine"]
    if pose:
        leaves.append(torch.zeros((n_views, 3), dtype=torch.float32, device=dev,
                                  requires_grad=True))
    start = [t.detach().clone() for t in leaves]
    feasible = None
    if spec["carve"]:
        feasible = carve(train["origins"], train["directions"], train["pixel_values"], aabb,
                         res, near, far, spec["carve_thresh"])
    occs = torch.zeros((res,) * 3, dtype=torch.float32, device=dev)
    binary = torch.ones((res,) * 3, dtype=torch.bool, device=dev)
    if feasible is not None:
        binary &= feasible
    table = sampling_table(train["weights"]) if spec["weighted"] else None
    gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in leaves]
    targets, losses, pixels, grad0, binary0 = [], [], [], None, None
    for s in range(n_steps):
        if table is None:
            raise ValueError("the reference follows the weighted overdraw sampler only")
        rows = overdraw_rows(gen, table, spec["batch"], train["origins"].shape[0])
        o, d, t = (train[k].index_select(0, rows) for k in ("origins", "directions",
                                                             "pixel_values"))
        if s % spec["grid_update_every"] == 0:
            if s >= spec["grid_warmup_steps"]:
                raise ValueError("the reference follows the dense grid updates only")
            occs, binary = dense_grid_update(occs, feasible, [p.detach() for p in mlp], aabb,
                                             res, spec["alpha_thre"], spec["grid_ema_decay"],
                                             scale, encoder([p.detach() for p in enc_leaves], s),
                                             quant)
        if s == 0:
            binary0 = binary.clone()
        if pose:
            o = o + leaves[-1].index_select(0, train["image_ids"].index_select(0, rows))
        px = render(mlp, binary, aabb, o, d, near, far, n, stride, spec["early_stop_eps"],
                    scale, encoder(enc_leaves, s), quant)
        loss = torch.mean((px - t) ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        lr = lr_at(spec["lr"], spec["decay_rate"], spec["decay_steps"], s, dev)
        with torch.no_grad():
            for i, (p, g, (m, v)) in enumerate(zip(leaves, grads, moments)):
                if pose and i == len(leaves) - 1:
                    plr = torch.tensor(0.0 if s < spec["pose_start"] else spec["pose_lr"],
                                       dtype=torch.float32, device=dev)
                    adam_update(p, g, m, v, s + 1, plr, spec["pose_weight_decay"])
                else:
                    adam_update(p, g, m, v, s + 1, lr)
        if s == 0:
            grad0 = [g.detach().clone() for g in grads]
        targets.append(t)
        pixels.append(px.detach())
        losses.append(float(loss.detach()))
    return dict(start=start, feasible=feasible, binary0=binary0, targets=targets,
                pixels=pixels, losses=losses, grad0=grad0, leaves=[p.detach().clone() for p in leaves],
                shifts=pose)
