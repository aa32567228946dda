"""Training step, render and eval in torch (port of
``nerf_for_angiography_tpu/training/train.py``; the reference's hot loop,
nerf/run_nerf_acc.py:263-440).

Per step: sample a ray batch on the device, EMA-update the two occupancy
grids every ``grid_update_every`` steps from one shared sigma pass, march
(the dense lattice, or with ``0 < compact_samples < depth_samples_per_ray``
the compacted march ``march_mode`` names), evaluate the MLP (the fused
kernels on the card: the encoded pair for pos_enc 'fourier' / 'barf', at
the BARF alpha of the step counter), composite with
Beer-Lambert under the early-stop keep
mask, take the MSE and apply Adam with continuous exponential lr decay. A
compacted step also reports its truncation pressure (march_pressure). With
``fused_train_step`` the MLP forward, composite, loss gradient and MLP
backward of each rectangular march are one call of the whole-step kernel
(ops/kernels/fused_step.py); with ``feature_major_mlp`` the fused-MLP
kernels take the march's positions as one (3, P) block. With
``pose_refine`` each ray's origin takes its view's learnable translation
(shifted_origins) before the march, and the MLP kernels' position gradient
carries the loss back to the translations.

The compact-mode chooser (choose_compact_mode and its sizers) probes the
held-out view with one device pass reduced to five int32 values, read with
one device-to-host copy; the loop calls it at chunk boundaries only.

PyTorch runs eagerly, so there is no jit: ``make_train_step`` returns a
plain callable. No step reads the device: every shape is fixed by the
configuration, and the grid gate reads the state's host-side step counter.
Nor does a step read a host value that changes from step to step: the lr
and the BARF alpha are computed on the device from the state's device step
counter, and the grids are written in place. So ``make_train_chunk`` (the
JAX package's chunk of steps) can replay each step on the card as one
captured CUDA graph (training/graph.py).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..device import resolve_device
from ..models import CPPN, barf_alpha_device, barf_k_values, barf_weights
from ..ops.kernels.fused_mlp import cppn_params_to_list, fused_mlp_raw, fused_mlp_raw_fm
from ..ops.kernels.fused_mlp_enc import fused_mlp_enc_raw
from ..ops.kernels.fused_step import fused_step_grads
from ..ops.occupancy import (
    BucketedRays,
    MarchedRays,
    OccupancyGrid,
    coarse_window,
    create_grid,
    every_n_step_pair,
    grid_update_kind,
    march_rays,
    march_rays_hybrid,
    march_rays_hybrid2,
    march_rays_hybrid2k,
    march_rays_window,
    prune_mask,
    safe_occ_stride,
    share_march,
)
from ..ops.rendering import psnr_from_mse
from ..ops.sampling import RayBatch, RayDataset, sample_image_rays, sample_pixel_rays
from ..parallel import collectives
from ..parallel.mesh import mesh_coords
from ..utils.profiling import annotate
from .config import TrainConfig
from .graph import TrainChunk

# truncation-pressure scalars the tuner observes each chunk, in the order
# PressureTuner.observe takes them
PRESSURE_KEYS = (
    "march/over_k", "march/over_k_lo", "march/edge_rays",
    "march/ac", "march/ac_lo",
)


@dataclasses.dataclass
class TrainState:
    """The JAX TrainState in PyTorch form: the module owns the parameters,
    the optimizer the Adam state, ``scheduler`` the lr schedule
    (ExponentialDecayLR) and ``generator`` replaces the PRNG key. The step
    counter is kept twice: ``step`` on the host (the loop's cadences and the
    grid gate read it) and ``step_dev``, an int32 0-dim tensor on the
    state's device (the lr and the BARF alpha are computed from it, so a
    captured step reads no host value that changes). Setting ``step`` sets
    both; ``advance`` moves both on by one."""

    model: CPPN
    optimizer: torch.optim.Optimizer
    scheduler: Any
    grid: OccupancyGrid  # scene grid, alpha_thre=1e-4 (run_nerf_acc.py:197)
    vessel_grid: OccupancyGrid  # vessel grid, 5e-2 (run_nerf_acc.py:198)
    step: int
    generator: torch.Generator
    step_dev: torch.Tensor | None = None

    def __post_init__(self):
        if self.step_dev is None:
            self.step_dev = torch.full((), int(self.step), dtype=torch.int32,
                                       device=self.grid.occs.device)

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name == "step" and self.__dict__.get("step_dev") is not None:
            self.step_dev.fill_(int(value))

    def advance(self) -> None:
        """One step on: the device counter in place (a CUDA graph replays
        the add), the host counter without a write to the device."""
        self.step_dev.add_(1)
        self.__dict__["step"] = self.step + 1


class TestView(NamedTuple):
    """Held-out view tensors (run_nerf_acc.py:84-107)."""

    origins: torch.Tensor
    directions: torch.Tensor
    pixel_values: torch.Tensor
    vessel_mask: torch.Tensor  # bool: distance_pixel_value > mean
    x_positions: torch.Tensor
    y_positions: torch.Tensor
    img_width: int
    img_height: int


def make_test_view(rays: RayDataset, view_index: int, rays_per_view: int) -> TestView:
    """The held-out view, by default the last (custom) one
    (run_nerf_acc.py:85)."""
    s = view_index * rays_per_view
    e = s + rays_per_view
    w = rays.weights[s:e]
    xp, yp = rays.x_positions[s:e], rays.y_positions[s:e]
    return TestView(
        origins=rays.origins[s:e],
        directions=rays.directions[s:e],
        pixel_values=rays.pixel_values[s:e],
        vessel_mask=w > w.mean(),
        x_positions=xp,
        y_positions=yp,
        img_width=int(xp.max()) + 1,
        img_height=int(yp.max()) + 1,
    )


def drop_test_view(rays: RayDataset, view_index: int, rays_per_view: int) -> RayDataset:
    """Training rays = every view except the held-out one (any sampling
    table is dropped; it indexes the old ray set)."""
    s = view_index * rays_per_view
    e = s + rays_per_view

    def take(a):
        return torch.cat([a[:s], a[e:]], dim=0)

    per_ray = (
        "origins", "directions", "pixel_values", "weights", "image_ids",
        "x_positions", "y_positions",
    )
    return RayDataset(**{n: take(getattr(rays, n)) for n in per_ray}, sampling_table=None)


class ExponentialDecayLR:
    """The reference's continuous exponential lr decay lr * 0.1^(step/500k)
    (run_nerf_acc.py:322-328) as optax's exponential_decay(staircase=False)
    computes it from its count: init * rate^(f32(count) / f32(steps)), in
    f32. ``apply(step_dev)`` computes it on the device from the state's step
    counter and writes it into the optimizer's lr tensor in place, ahead of
    the Adam step (so a captured step reads it from the device). Its state
    is its three constants; the count is the state's step."""

    def __init__(self, optimizer, init_value: float, decay_rate: float, transition_steps: int):
        self.optimizer = optimizer
        self.init_value = float(init_value)
        self.decay_rate = float(decay_rate)
        self.transition_steps = int(transition_steps)

    def value(self, count: torch.Tensor) -> torch.Tensor:
        """The lr at step ``count`` (an integer tensor), f32 on its device."""
        def f32(v):
            return torch.full((), v, dtype=torch.float32, device=count.device)

        p = count.to(torch.float32) / f32(self.transition_steps)
        return f32(self.init_value) * torch.pow(f32(self.decay_rate), p)

    def apply(self, count: torch.Tensor) -> None:
        lr = self.value(count)
        for group in self.optimizer.param_groups:
            group["lr"].copy_(lr)

    def state_dict(self) -> dict:
        return {"init_value": self.init_value, "decay_rate": self.decay_rate,
                "transition_steps": self.transition_steps}

    def load_state_dict(self, state: dict) -> None:
        self.init_value = float(state["init_value"])
        self.decay_rate = float(state["decay_rate"])
        self.transition_steps = int(state["transition_steps"])


def make_optimizer(cfg: TrainConfig, params, pose_params=None):
    """Adam (eps 1e-8) and its lr schedule (ExponentialDecayLR). The lr is
    an f32 tensor on the parameters' device that the schedule rewrites
    before each step. ``fused`` updates every parameter of a group in one
    launch and ``capturable`` lets the step be captured into a CUDA graph.

    With ``pose_params`` (the view shifts of pose refinement) the optimizer
    is AdamW with two groups, as the JAX package's optax.multi_transform:
    the model's parameters without weight decay (Adam, at the decaying lr)
    and the view shifts with ``pose_weight_decay``, whose lr tensor the step
    sets to pose_lr_at after the schedule. torch's AdamW decays the
    parameter by p (1 - lr wd) where optax adds wd p to the update before
    the lr scales it: the same update up to rounding, and none while the
    lr is 0."""
    params = list(params)
    dev = params[0].device
    lr = torch.full((), cfg.coarse_lr, dtype=torch.float32, device=dev)
    kw = dict(betas=(0.9, 0.999), eps=1e-8, fused=True, capturable=True)
    if pose_params is None:
        opt = torch.optim.Adam(params, lr=lr, **kw)
    else:
        pose_lr = torch.zeros((), dtype=torch.float32, device=dev)
        opt = torch.optim.AdamW(
            [{"params": params, "lr": lr, "weight_decay": 0.0},
             {"params": list(pose_params), "lr": pose_lr,
              "weight_decay": cfg.pose_weight_decay}],
            lr=lr, **kw)
    return opt, ExponentialDecayLR(opt, cfg.coarse_lr, cfg.decay_rate, cfg.decay_steps)


def pose_lr_at(cfg: TrainConfig, count: torch.Tensor) -> torch.Tensor:
    """The view shifts' lr at step ``count`` (an integer tensor), the JAX
    package's pose schedule where(step < pose_start, 0, pose_lr), f32 on the
    count's device."""
    zero = torch.zeros((), dtype=torch.float32, device=count.device)
    return torch.where(count < cfg.pose_start, zero, torch.full_like(zero, cfg.pose_lr))


def create_train_state(
    cfg: TrainConfig, seed: int | None = None, num_views: int | None = None,
    device: str | torch.device = "cuda",
) -> tuple[CPPN, TrainState]:
    """Model, optimizer and the two fresh grids. Weights are drawn on the CPU
    from ``seed`` (default cfg.seed) so they do not depend on the device.
    With ``pose_refine`` the module also holds ``view_shifts``, (num_views,
    3) zeros (CPPN.add_view_shifts), under its own AdamW group."""
    device = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    init_gen = torch.Generator().manual_seed(seed)
    model = CPPN(cfg.model_config(), generator=init_gen).to(device)
    if cfg.pose_refine:
        if not num_views:
            raise ValueError("pose_refine needs num_views")
        model.add_view_shifts(num_views)
        field = [p for n, p in model.named_parameters() if n != "view_shifts"]
        opt, sched = make_optimizer(cfg, field, [model.view_shifts])
    else:
        opt, sched = make_optimizer(cfg, model.parameters())
    aabb = [-cfg.outside] * 3 + [cfg.outside] * 3
    grid = create_grid(aabb, cfg.grid_resolution, device=device)
    vessel_grid = create_grid(aabb, cfg.grid_resolution, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return model, TrainState(
        model=model, optimizer=opt, scheduler=sched, grid=grid, vessel_grid=vessel_grid,
        step=0, generator=gen,
    )


def copy_state(state: TrainState) -> TrainState:
    """A copy of a train state that shares no tensor with it: the module,
    the optimizer (Adam state and lr), the schedule, both grids, the
    generator's state and the step."""
    # one deepcopy: the copied optimizer and schedule refer to the copied
    # parameters and optimizer
    model, opt, sched = copy.deepcopy((state.model, state.optimizer, state.scheduler))
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())

    def grid_copy(g: OccupancyGrid) -> OccupancyGrid:
        return OccupancyGrid(*(None if t is None else t.clone() for t in g))

    return TrainState(model=model, optimizer=opt, scheduler=sched, grid=grid_copy(state.grid),
                      vessel_grid=grid_copy(state.vessel_grid), step=state.step, generator=gen)


def _pallas_eligible(model: CPPN) -> bool:
    """The fused kernels cover the relu density stack with pos_enc 'none'
    (fused_mlp_raw) and 'fourier' / 'barf' with pos_enc_basis > 0
    (fused_mlp_enc_raw, the encode in the kernel)."""
    c = model.config
    enc_ok = c.pos_enc == "none" or (c.pos_enc in ("fourier", "barf") and c.pos_enc_basis > 0)
    return (
        enc_ok
        and c.act_func == "relu"
        and c.num_late_layers == 0
        and c.num_input_channels == 3
        and c.num_input_channels_views == 0
        and c.num_output_channels == 1
    )


def barf_alpha_of(cfg: TrainConfig, step_dev: torch.Tensor) -> torch.Tensor:
    """The BARF anneal alpha (run_nerf_acc.py:268-272) at the device step
    counter, an f32 0-dim tensor on its device; 0 for other encodings."""
    if cfg.pos_enc != "barf":
        return torch.zeros((), dtype=torch.float32, device=step_dev.device)
    return barf_alpha_device(step_dev, cfg.pos_enc_basis, cfg.barf_start, cfg.barf_stop)


def density_raw(
    model: CPPN, pts: torch.Tensor, barf_alpha=0.0, backend: str = "auto"
) -> torch.Tensor:
    """Raw 1-channel density at pts (..., 3) -> (...,).

    'pallas' (the JAX package's name for the fused kernels) and 'auto' on an
    eligible model go through ``fused_mlp_raw`` (pos_enc 'none') or
    ``fused_mlp_enc_raw`` (fourier with the module's coefficients, BARF with
    the window at ``barf_alpha``, a float or a 0-dim tensor on pts' device):
    the CUDA kernels for CUDA tensors, their plain versions for CPU tensors.
    'xla' runs the module's own forward."""
    if backend == "pallas" and not _pallas_eligible(model):
        raise ValueError(
            "mlp_backend='pallas' needs pos_enc 'none' (or 'fourier'/'barf' with "
            "pos_enc_basis > 0), relu, no view branch/late layers"
        )
    if backend in ("pallas", "auto") and _pallas_eligible(model):
        c = model.config
        x = (pts.reshape(-1, 3) * c.input_scale).contiguous()
        plist = cppn_params_to_list(model)
        if c.pos_enc == "none":
            raw = fused_mlp_raw(plist, x)
        else:
            if c.pos_enc == "fourier":
                enc = {"coeff": model.fourier_coefficients_pts}
            else:  # barf: the window at the current anneal alpha
                enc = {"w": barf_weights(barf_alpha,
                                         barf_k_values(c.pos_enc_basis, 3, device=x.device))}
            raw = fused_mlp_enc_raw((c.pos_enc, c.pos_enc_basis), plist, enc, x)
        return raw.reshape(pts.shape[:-1])
    if backend not in ("auto", "xla"):
        raise ValueError(f"unknown mlp_backend {backend!r}")
    return model(pts, barf_alpha)[..., -1]


def density_raw_fm(
    model: CPPN, pts_fm: torch.Tensor, barf_alpha=0.0, backend: str = "auto"
) -> torch.Tensor:
    """density_raw for a feature-major (3, P) point block -> (P,).

    On the fused-kernel path of a pos_enc 'none' model ('auto' or 'pallas')
    the block goes to ``fused_mlp_raw_fm`` as it is, with no relayout; every
    other configuration (the encoded models among them, as in the JAX
    package) transposes it back to density_raw."""
    if (backend in ("pallas", "auto") and _pallas_eligible(model)
            and model.config.pos_enc == "none"):
        x = (pts_fm * model.config.input_scale).contiguous()
        return fused_mlp_raw_fm(cppn_params_to_list(model), x)
    return density_raw(model, pts_fm.T, barf_alpha, backend)


def _sigma_fn(model: CPPN, barf_alpha=0.0, backend: str = "auto"):
    """Density closure: sigmoid of the raw output (nerf_helpers_acc.py:22-24)."""

    def fn(pts):
        return torch.sigmoid(density_raw(model, pts, barf_alpha, backend))

    return fn


def _stride_for(cfg: TrainConfig, near: float, far: float) -> int:
    return safe_occ_stride(
        cfg.occ_stride, cfg.depth_samples_per_ray, near, far,
        2 * cfg.outside, cfg.grid_resolution,
    )


def _march_for(cfg, grid, origins, directions, near, far, shard=None):
    """Marching strategy dispatch. The dense lattice when compaction is off;
    with compaction, 'window' (contiguous lattice window via the dilated
    coarse grid), 'hybrid' (first-k inside a span-sized window; two buckets
    with hybrid_split and hybrid_w_lo, and a k per bucket with
    hybrid_bucket_k and hybrid_k_lo) or 'lattice' (first-k of the whole
    lattice) per cfg.march_mode.

    With ``shard=(rank, world)`` the rays are the whole batch and only this
    rank's share is marched: returns (march, rows), the batch rows the
    march's rows hold. The two-bucket marches sort and cut the whole batch
    and march this rank's slice of each bucket; every other march works
    ray by ray and takes this rank's contiguous slice."""
    n = cfg.depth_samples_per_ray
    compacting = 0 < cfg.compact_samples < n

    def hybrid_kw():
        return dict(
            w_cap=cfg.hybrid_w_cap or None, aabb_extent=2 * cfg.outside,
            occ_stride=_stride_for(cfg, near, far), fka=cfg.march_fka,
        )

    if (compacting and cfg.march_mode == "hybrid" and cfg.hybrid_split > 0.0
            and cfg.hybrid_w_lo > 0):
        if cfg.hybrid_bucket_k and cfg.hybrid_k_lo > 0:
            return march_rays_hybrid2k(
                grid, origins, directions, n, near, far, k=cfg.compact_samples,
                k_lo=cfg.hybrid_k_lo, w_lo=cfg.hybrid_w_lo, split=cfg.hybrid_split,
                shard=shard, **hybrid_kw(),
            )
        return march_rays_hybrid2(
            grid, origins, directions, n, near, far, k=cfg.compact_samples,
            w_lo=cfg.hybrid_w_lo, split=cfg.hybrid_split, shard=shard, **hybrid_kw(),
        )
    if shard is not None:
        return share_march(lambda g, o, d: _march_for(cfg, g, o, d, near, far),
                           grid, origins, directions, shard)
    if compacting and cfg.march_mode == "window":
        return march_rays_window(
            grid, origins, directions, n, near, far,
            k=cfg.compact_samples, aabb_extent=2 * cfg.outside,
        )
    if compacting and cfg.march_mode == "hybrid":
        return march_rays_hybrid(
            grid, origins, directions, n, near, far, k=cfg.compact_samples, **hybrid_kw()
        )
    return march_rays(
        grid, origins, directions, n, near, far,
        compact_k=cfg.compact_samples if compacting else None,
        occ_stride=_stride_for(cfg, near, far), fka=cfg.march_fka,
    )


@torch.no_grad()
def _chooser_stats_device(n, near, far, k, aabb_extent, split, grid, o, d) -> torch.Tensor:
    """The chooser's probe as ONE device pass reduced to a (5,) int32
    tensor [ac, span, win_w, span_q, ac_lo]:

      ac     - max per-ray active sample count of the dense lattice
      span   - max per-ray (last active - coarse-window start + 1), the
               hybrid candidate-window requirement (from the unclamped
               start: the march's far-end clamp only moves the window
               earlier)
      win_w  - max per-ray (last active - k-window start + 1), the 'window'
               mode width
      span_q - with split > 0: the ``split``-quantile of the coarse span
               over HIT rays (sizes the two-bucket w_lo); 0 otherwise
      ac_lo  - with split > 0: the max active count among the lo bucket's
               rays (hit rays with coarse span <= span_q; sizes k_lo); 0
               otherwise."""
    dm = march_rays(grid, o, d, n, near, far).mask > 0
    counts = dm.sum(dim=-1, dtype=torch.int32)
    ac = counts.amax()
    has = dm.any(dim=-1)
    last = (dm.shape[-1] - 1) - torch.argmax(torch.flip(dm, dims=(-1,)).to(torch.uint8), dim=-1)
    zero = torch.zeros((), dtype=torch.int64, device=o.device)
    c_start, c_end, c_hit = coarse_window(grid, o, d, n, near, far, aabb_extent=aabb_extent)
    start = torch.clamp(c_start, min=0)
    span = torch.where(has, last - start + 1, zero).amax()
    t0 = march_rays_window(grid, o, d, n, near, far, k=k, aabb_extent=aabb_extent).t_starts[:, 0]
    step_sz = (far - near) / n
    w0 = torch.round((t0 - near) / step_sz).to(torch.int32)
    win_w = torch.where(has, last - w0 + 1, zero).amax()
    if split > 0.0:
        # hit-only quantile with static shapes: the coarse spans sorted
        # descending (misses carry 0 and sort last), indexed at the
        # split-quantile rank among the n_hit leading entries. The rank is
        # computed in f32, as the JAX package computes it.
        cspan = torch.where(c_hit, c_end - c_start + 1, torch.zeros_like(c_end))
        sq = torch.flip(torch.sort(cspan).values, dims=(0,))
        n_hit = c_hit.sum(dtype=torch.int32)
        idx = torch.clamp(
            n_hit - torch.ceil(n_hit.to(torch.float32) * split).to(torch.int32),
            0, cspan.shape[0] - 1,
        )
        # index_select keeps the index on the device (indexing with a 0-dim
        # tensor would read it on the host)
        span_q = sq.index_select(0, idx.reshape(1).to(torch.int64)).reshape(())
        lo_sel = c_hit & (cspan <= span_q)
        ac_lo = torch.where(lo_sel, counts, torch.zeros_like(counts)).amax()
    else:
        span_q = ac_lo = zero
    return torch.stack([v.to(torch.int32) for v in (ac, span, win_w, span_q, ac_lo)])


def _chooser_stats(cfg, grid, origins, directions, near, far) -> tuple[int, int, int, int, int]:
    """(ac, span, win_w, span_q, ac_lo) of _chooser_stats_device, read with
    one device-to-host copy."""
    t = _chooser_stats_device(
        cfg.depth_samples_per_ray, near, far, cfg.compact_samples, 2 * cfg.outside,
        cfg.hybrid_split, grid, origins, directions,
    )
    ac, span, win_w, span_q, ac_lo = t.tolist()
    return ac, span, win_w, span_q, ac_lo


def compact_switch_width(cfg, grid, origins, directions, near, far, mode=None) -> int:
    """Max per-ray sample width the compacted stepper would need to render
    these rays losslessly in ``mode`` (default cfg.march_mode): 'lattice'
    the max active count, 'window' the max span from the k-window start,
    'hybrid' the max active count when the span-derived window stays
    cheaper than the lattice march, else n_samples (never engages)."""
    mode = cfg.march_mode if mode is None else mode
    n = cfg.depth_samples_per_ray
    ac, span, win_w, _, _ = _chooser_stats(cfg, grid, origins, directions, near, far)
    if mode == "lattice":
        return ac
    if mode == "window":
        return win_w
    return ac if hybrid_w_cap_for(span, n) <= _max_hybrid_w_cap(n) else n


def hybrid_w_cap_for(span: int, n_samples: int) -> int:
    """Adaptive hybrid candidate window: the measured worst-ray span,
    bucketed to 16 (a handful of distinct step shapes per run), floored at
    160, with no grid-evolution margin (the loop re-measures and grows
    it)."""
    return min(n_samples, max(160, -(-int(span) // 16) * 16))


def _max_hybrid_w_cap(n_samples: int) -> int:
    """Beyond ~3/4 of the lattice the hybrid's fine probes approach the
    lattice march's while it still pays the coarse window: fall through to
    'lattice' there."""
    return max(160, (3 * n_samples) // 4)


def hybrid_w_lo_for(span_q: int, w_cap: int) -> int:
    """Two-bucket lo window from the hit-ray span quantile, bucketed to 16
    plus one bucket of margin, floor 32, capped at w_cap (where the split
    is pointless and the caller disables it)."""
    return min(w_cap, max(32, -(-int(span_q) // 16) * 16 + 16))


class CompactChoice(NamedTuple):
    """Compacted-march tuning from the chooser's probe: the mode, the
    measured lossless active width (sizes k via compact_k_for), for
    'hybrid' the span-sized candidate window (0 = none), with
    cfg.hybrid_split > 0 the two-bucket lo window (0 = single bucket), and
    with cfg.hybrid_bucket_k the measured lo-bucket active width (sizes
    k_lo via compact_k_lo_for; 0 = single k)."""

    mode: str
    width: int
    w_cap: int = 0
    w_lo: int = 0
    width_lo: int = 0


def choose_compact_mode(cfg, grid, origins, directions, near, far) -> CompactChoice | None:
    """Pick the cheapest compacted march that renders these rays losslessly
    at k = cfg.compact_samples (or, with compact_engage_max above it, at
    the interim cap), or None if none fits yet. The chain is window ->
    hybrid -> lattice for march_mode 'window', hybrid -> lattice for
    'hybrid'; the per-bucket-k hybrid is preferred over the window when its
    effective k undercuts the window's by more than 32."""
    if not (0 < cfg.compact_samples < cfg.depth_samples_per_ray):
        return None
    budget = int(0.9 * cfg.compact_samples)
    emax = cfg.compact_engage_max
    if emax > cfg.compact_samples:
        budget = int(0.9 * min(emax, cfg.depth_samples_per_ray - 1))
    n = cfg.depth_samples_per_ray
    chains = {
        "window": ("window", "hybrid", "lattice"),
        "hybrid": ("hybrid", "lattice"),
    }
    modes = chains.get(cfg.march_mode, (cfg.march_mode,))
    ac, span, win_w, span_q, ac_lo = _chooser_stats(cfg, grid, origins, directions, near, far)

    def hybrid_candidate() -> CompactChoice | None:
        wcap = hybrid_w_cap_for(span, n)
        if ac > budget or wcap > _max_hybrid_w_cap(n):
            return None
        w_lo = 0
        width_lo = 0
        if cfg.hybrid_split > 0.0:
            w_lo = hybrid_w_lo_for(span_q, wcap)
            if w_lo >= wcap:
                w_lo = 0  # no narrow majority: single bucket
            elif cfg.hybrid_bucket_k:
                # the lo bucket's march keeps <= min(ac_lo, w_lo) actives
                width_lo = min(ac_lo, w_lo)
        return CompactChoice("hybrid", ac, wcap, w_lo, width_lo)

    for mode in modes:
        if mode == "window" and win_w <= budget:
            if cfg.hybrid_bucket_k and cfg.hybrid_split > 0.0:
                hyb = hybrid_candidate()
                if hyb is not None and hyb.width_lo:
                    k_win = compact_k_for(win_w, cfg)
                    k_h = compact_k_for(hyb.width, cfg)
                    k_lo = compact_k_lo_for(hyb.width_lo, k_h, cfg)
                    if k_lo:
                        s = cfg.hybrid_split
                        k_eff = s * k_lo + (1.0 - s) * k_h
                        if k_eff + 32 <= k_win:
                            return hyb
            return CompactChoice("window", win_w)
        if mode == "hybrid":
            hyb = hybrid_candidate()
            if hyb is not None:
                return hyb
        if mode == "lattice" and ac <= budget:
            return CompactChoice("lattice", ac)
    return None


def compact_k_for(width: int, cfg: TrainConfig) -> int:
    """Runtime compaction width: the measured lossless width times the
    grid-evolution margin (cfg.compact_k_margin), rounded up to a multiple
    of 8 and capped at cfg.compact_samples; above it (interim engagement,
    compact_engage_max) bucketed to 32 and capped at the engage max."""
    margin = cfg.compact_k_margin
    k = int(math.ceil(width * margin / 8)) * 8
    if k <= cfg.compact_samples:
        return max(16, k)
    emax = cfg.compact_engage_max
    if emax > cfg.compact_samples:
        k32 = int(math.ceil(width * margin / 32)) * 32
        return max(16, min(k32, emax))
    return max(16, min(k, cfg.compact_samples))


def compact_k_lo_for(width_lo: int, k: int, cfg: TrainConfig) -> int:
    """Runtime lo-bucket compaction width (march_rays_hybrid2k): the
    measured lo-bucket width with compact_k_for's margin and 8-rounding;
    0 when it would reach k (the split buys nothing)."""
    if width_lo <= 0:
        return 0
    k_lo = max(16, int(math.ceil(width_lo * cfg.compact_k_margin / 8)) * 8)
    return 0 if k_lo >= k else k_lo


def _flat_positions(m) -> torch.Tensor:
    """Sample positions of a march result as one (P, 3) point batch; the
    two buckets of BucketedRays concatenate (lo first) so one MLP call
    serves both."""
    if isinstance(m, BucketedRays):
        return torch.cat([m.lo.positions.reshape(-1, 3), m.hi.positions.reshape(-1, 3)], dim=0)
    return m.positions.reshape(-1, 3)


def _rect_marches(m, *per_ray: torch.Tensor) -> list:
    """[(rectangular march, per-ray tensors in its ray order), ...]: the
    march itself, or the lo and hi buckets of BucketedRays with their rays
    taken through m.perm."""
    if isinstance(m, BucketedRays):
        cut = m.lo.t_starts.shape[0]
        rays = [a.index_select(0, m.perm) for a in per_ray]
        return [(m.lo, [a[:cut] for a in rays]), (m.hi, [a[cut:] for a in rays])]
    return [(m, list(per_ray))]


def _flat_positions_fm(m, origins: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Sample positions of a march result as one feature-major (3, P) block
    (the layout fused_mlp_raw_fm takes), recomputed as o + d * t_mid from
    the march's (t_starts + t_ends) / 2, buckets concatenated lo first.
    Within 1 ulp of the march's own positions."""
    blocks = []
    for mm, (o, d) in _rect_marches(m, origins, directions):
        t_mid = (mm.t_starts + mm.t_ends) * 0.5  # (R, k)
        blocks.append((o.T[:, :, None] + d.T[:, :, None] * t_mid[None]).reshape(3, -1))
    return torch.cat(blocks, dim=1)


def _bucket_sigmas(m, raw: torch.Tensor):
    """The flat MLP output split back into per-bucket (R_b, k_b) sigma
    blocks: [(march, sigma), ...], one entry for a rectangular march."""
    sig = torch.sigmoid(raw)
    if isinstance(m, BucketedRays):
        n_lo = m.lo.mask.numel()
        return [
            (m.lo, sig[:n_lo].reshape(m.lo.mask.shape)),
            (m.hi, sig[n_lo:].reshape(m.hi.mask.shape)),
        ]
    return [(m, sig.reshape(m.mask.shape))]


def _raw_for(model, m, origins, directions, cfg: TrainConfig, barf_alpha=0.0) -> torch.Tensor:
    """MLP raw densities of a march result, flat (P,) in bucket order:
    feature-major when cfg.feature_major_mlp asks for it, point-major
    otherwise."""
    if cfg.feature_major_mlp:
        return density_raw_fm(
            model, _flat_positions_fm(m, origins, directions), barf_alpha, cfg.mlp_backend
        )
    return density_raw(model, _flat_positions(m), barf_alpha, cfg.mlp_backend)


def _keep_mask(m: MarchedRays, sigma: torch.Tensor, cfg: TrainConfig):
    """(dists, keep): alpha_thre only under train_alpha_prune, early stop at
    early_stop_eps, on detached sigma."""
    dists = m.t_ends - m.t_starts
    keep = prune_mask(
        sigma, dists, m.mask,
        cfg.alpha_thre if cfg.train_alpha_prune else 0.0,
        cfg.early_stop_eps,
    )
    return dists, keep.detach()


def render_rays(
    model: CPPN, grid: OccupancyGrid, origins: torch.Tensor, directions: torch.Tensor,
    cfg: TrainConfig, near: float, far: float, barf_alpha=0.0,
    binary_thresh: float | None = None, return_march: bool = False, march=None,
):
    """Grid-pruned masked render of a ray batch, differentiable in the model
    parameters (run_nerf_acc.py:287-296), the BARF window at ``barf_alpha``.
    Returns (pixels, sigma, keep),
    plus the march result with ``return_march`` (for march_pressure).
    pixels are in input ray order; under the per-bucket-k march
    (BucketedRays) sigma and keep are flat (P,) tensors in bucket order.
    ``march``: the march of these rays, made already (a rank's share of a
    sharded batch, ``_march_for(shard=)``)."""
    m = march
    if m is None:
        with annotate("step/march"):
            m = _march_for(cfg, grid, origins, directions, near, far)
    with annotate("step/mlp_fwd"):
        raw = _raw_for(model, m, origins, directions, cfg, barf_alpha)
    with annotate("step/composite"):
        parts, sigmas, keeps = [], [], []
        for mb, sb in _bucket_sigmas(m, raw):
            dists, keep = _keep_mask(mb, sb, cfg)
            if binary_thresh is not None:
                sb = torch.where(sb < binary_thresh, torch.zeros_like(sb), sb)
            parts.append(torch.exp(-(sb * keep * dists).sum(dim=-1)))
            sigmas.append(sb)
            keeps.append(keep)
        if isinstance(m, BucketedRays):
            pixels = torch.cat(parts).index_select(0, m.inv)
            sigma = torch.cat([s.reshape(-1) for s in sigmas])
            keep = torch.cat([k.reshape(-1) for k in keeps])
        else:
            pixels, sigma, keep = parts[0], sigmas[0], keeps[0]
    if return_march:
        return pixels, sigma, keep, m
    return pixels, sigma, keep


def render_rays_with_binary(
    model: CPPN, grid: OccupancyGrid, origins: torch.Tensor, directions: torch.Tensor,
    cfg: TrainConfig, near: float, far: float, binary_thresh: float, barf_alpha=0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normal and binary renders from ONE march and MLP evaluation (the two
    differ only in zeroing sub-threshold densities, visualization.py:343-352).
    The keep mask comes from the sigma before the threshold. Both pixel sets
    are in input ray order."""
    m = _march_for(cfg, grid, origins, directions, near, far)
    raw = _raw_for(model, m, origins, directions, cfg, barf_alpha)
    parts, bparts = [], []
    for mb, sigma in _bucket_sigmas(m, raw):
        dists, keep = _keep_mask(mb, sigma, cfg)
        parts.append(torch.exp(-(sigma * keep * dists).sum(dim=-1)))
        bsigma = torch.where(sigma < binary_thresh, torch.zeros_like(sigma), sigma)
        bparts.append(torch.exp(-(bsigma * keep * dists).sum(dim=-1)))
    if isinstance(m, BucketedRays):
        return torch.cat(parts).index_select(0, m.inv), torch.cat(bparts).index_select(0, m.inv)
    return parts[0], bparts[0]


def _fused_step_eligible(model: CPPN, cfg: TrainConfig) -> bool:
    """Whether the whole-train-step kernel replaces the split forward /
    backward for this model and config: pos_enc 'none' (the encoded models
    keep the split kernels), relu, no
    pose_refine (the kernel returns no position gradient), no
    train_alpha_prune (it replays the early-stop keep only) and an
    mlp_backend of 'auto' or 'pallas'. 'on' forces it (the plain version on
    CPU tensors) and raises ValueError for an ineligible model or config;
    'auto' engages when the model lives on the card."""
    mode = cfg.fused_train_step
    if mode == "off":
        return False
    if mode not in ("on", "auto"):
        raise ValueError(f"fused_train_step must be 'off', 'on' or 'auto', got {mode!r}")
    ok = (
        model.config.pos_enc == "none"
        and _pallas_eligible(model)  # relu, no view branch / late layers
        and not cfg.pose_refine
        and not cfg.train_alpha_prune
        and cfg.mlp_backend in ("auto", "pallas")
    )
    if mode == "on":
        if not ok:
            raise ValueError(
                "fused_train_step='on' needs pos_enc='none', relu, no "
                "pose_refine/train_alpha_prune and a pallas-capable mlp_backend"
            )
        return True
    return ok and next(model.parameters()).device.type == "cuda"


def _fused_loss_and_grads(model: CPPN, grid, origins, directions, targets, cfg, near, far,
                          march=None, n_rays_loss: int | None = None):
    """March, then one fused_step_grads per rectangular march (one per
    bucket of BucketedRays: every ray lives in exactly one bucket, so the
    buckets' gradients sum, and both take the whole batch as the loss
    divisor). Returns (loss, pixels in input ray order, the march, grads in
    the plist layout). A rank's share of a sharded batch passes its
    ``march`` and the GLOBAL batch size as ``n_rays_loss``, the gradients'
    divisor (the returned loss stays the mean over these rays)."""
    plist = cppn_params_to_list(model)
    n_loss = origins.shape[0] if n_rays_loss is None else n_rays_loss
    kw = dict(
        step=(far - near) / cfg.depth_samples_per_ray,
        early_stop_eps=cfg.early_stop_eps,
        n_rays_loss=n_loss,
        input_scale=model.config.input_scale,
    )
    m = _march_for(cfg, grid, origins, directions, near, far) if march is None else march
    parts, grads = [], None
    for mm, (o, d, t) in _rect_marches(m, origins, directions, targets):
        t_mid = ((mm.t_starts + mm.t_ends) * 0.5).contiguous()
        px, g = fused_step_grads(plist, o, d, t_mid, mm.mask.contiguous(), t, **kw)
        parts.append(px)
        grads = g if grads is None else [(a + c, b + e) for (a, b), (c, e) in zip(grads, g)]
    pixels = torch.cat(parts)
    if isinstance(m, BucketedRays):
        pixels = pixels.index_select(0, m.inv)
    loss = torch.mean((pixels - targets) ** 2)
    return loss, pixels, m, grads


def _set_grads(model: CPPN, grads) -> None:
    """Write plist-layout gradients into the module's .grad (nn.Linear holds
    (out, in), the plist (in, out))."""
    for lin, (dw, db) in zip(model.linears(), grads):
        lin.weight.grad = dw.T.contiguous()
        if lin.bias is not None:
            lin.bias.grad = db.reshape(lin.bias.shape).contiguous()


def march_pressure(m) -> dict[str, torch.Tensor]:
    """Batch truncation-pressure scalars (0-dim int32) of a compacted march:

    over_k    - max over rays of (pre-compaction actives - emitted k): > 0
                means first-k compaction dropped active samples this step
    over_k_lo - the same for the lo bucket of a per-bucket-k march (0 single)
    edge_rays - rays whose candidate window's far edge is active (the active
                region may extend past w_cap / w_lo, or the coarse window
                past the k-window in window mode)
    ac/ac_lo  - the batch's max active count per ray (hi / lo bucket), the
                evidence the tuner's floor decay is gated on."""
    i32 = torch.int32
    if isinstance(m, BucketedRays):
        ac = m.hi.active_count.amax()
        ac_lo = m.lo.active_count.amax()
        return {
            "march/over_k": torch.clamp(ac - m.hi.mask.shape[-1], min=0).to(i32),
            "march/over_k_lo": torch.clamp(ac_lo - m.lo.mask.shape[-1], min=0).to(i32),
            "march/edge_rays": (m.lo.edge_active.sum() + m.hi.edge_active.sum()).to(i32),
            "march/ac": ac.to(i32),
            "march/ac_lo": ac_lo.to(i32),
        }
    ac = m.active_count.amax()
    zero = torch.zeros((), dtype=i32, device=ac.device)
    return {
        "march/over_k": torch.clamp(ac - m.mask.shape[-1], min=0).to(i32),
        "march/over_k_lo": zero,
        "march/edge_rays": m.edge_active.sum().to(i32),
        "march/ac": ac.to(i32),
        "march/ac_lo": zero,
    }


class _RowGather(torch.autograd.Function):
    """table[ids] for a (V, 3) table, whose backward sums each row's
    gradients in a fixed order: a one-hot (V, B) @ (B, 3) product in f64.
    (Indexing's own backward is an atomic scatter-add on the card, whose sum
    order changes from run to run.)"""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        rows = torch.arange(ctx.rows, device=ids.device)
        onehot = (rows[:, None] == ids[None, :]).to(torch.float64)
        return (onehot @ g.to(torch.float64)).to(g.dtype), None


def shifted_origins(model: CPPN, batch: RayBatch) -> torch.Tensor:
    """Pose refinement's ray origins: each ray's origin plus its view's
    learnable translation ``view_shifts[image_ids]`` (the gradient flows
    loss -> sigma -> MLP input -> positions -> origins -> shifts)."""
    return batch.origins + _RowGather.apply(model.view_shifts, batch.image_ids)


def _sharded_loss_and_grads(model: CPPN, grid, batch: RayBatch, cfg: TrainConfig, near: float,
                            far: float, barf_alpha, use_fused_step: bool, mesh):
    """This rank's share of one step over a 1-D mesh (the JAX step under a
    sharded batch, where XLA inserts the reductions).

    Every rank holds the whole batch (drawn in lockstep from generators that
    started equal) and marches its share (``_march_for(shard=)``: the
    two-bucket marches sort and cut the whole batch). Its gradient is that
    of the global mean: its pixels scattered into a zero vector of the
    global batch before the mean (split step), or the global batch size as
    the fused kernel's divisor. Then ONE all-reduce SUM of a flat buffer
    holding every parameter's gradient (the view shifts' among them), that
    pixel vector (each batch row is one rank's, so the sum assembles the
    global pixels) and the edge-ray count, and in a compacted step one MAX
    of the other pressure scalars. Returns (loss, pixels, pressure) of the
    global batch; the gradients in ``.grad`` are the global ones.

    With one rank both collectives are identities, the share is the whole
    batch in the order one process marches it, and the step is the
    unsharded step bit for bit."""
    shard = mesh_coords(mesh)
    n = batch.origins.shape[0]
    if use_fused_step:
        with annotate("step/fused"):
            m, rows = _march_for(cfg, grid, batch.origins, batch.directions, near, far,
                                 shard=shard)
            o, d, t = (a.index_select(0, rows) for a in (batch.origins, batch.directions,
                                                         batch.pixel_values))
            _, px, march, grads = _fused_loss_and_grads(model, grid, o, d, t, cfg, near, far,
                                                        march=m, n_rays_loss=n)
            _set_grads(model, grads)
            share = px.new_zeros(n).index_copy(0, rows, px)
    else:
        if cfg.pose_refine:
            with annotate("step/sample"):
                origins = shifted_origins(model, batch)
        else:
            origins = batch.origins
        with annotate("step/march"):
            m, rows = _march_for(cfg, grid, origins, batch.directions, near, far, shard=shard)
        px, _, _, march = render_rays(
            model, grid, origins.index_select(0, rows), batch.directions.index_select(0, rows),
            cfg, near, far, barf_alpha, return_march=True, march=m,
        )
        with annotate("step/composite"):
            # the rows of other ranks hold 0; index_copy's backward passes
            # only this rank's rows on, so their terms change no gradient
            share = px.new_zeros(n).index_copy(0, rows, px)
            loss = torch.mean((share - batch.pixel_values) ** 2)
        with annotate("step/backward"):
            loss.backward()
        share = share.detach()
    with annotate("step/allreduce"):
        compacting = 0 < cfg.compact_samples < cfg.depth_samples_per_ray
        pressure = march_pressure(march) if compacting else {}
        # the pixels first: the reductions over them (the loss, their mean)
        # then read an aligned block, as one process's do
        params = [p for p in model.parameters() if p.grad is not None]
        parts = [share] + [p.grad.reshape(-1) for p in params]
        if compacting:
            parts.append(pressure["march/edge_rays"].to(torch.float32).reshape(1))
        flat = collectives.all_reduce_(torch.cat(parts), mesh, "sum")
        pixels = flat[:n]
        off = n
        for p in params:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
            off += p.numel()
        if compacting:
            keys = ("march/over_k", "march/over_k_lo", "march/ac", "march/ac_lo")
            top = collectives.all_reduce_(torch.stack([pressure[k] for k in keys]), mesh, "max")
            reduced = {**dict(zip(keys, top.unbind())),
                       "march/edge_rays": flat[off].to(torch.int32)}
            pressure = {k: reduced[k] for k in pressure}
        return torch.mean((pixels - batch.pixel_values) ** 2), pixels, pressure


def _build_train_step(model: CPPN, cfg: TrainConfig, near: float, far: float,
                      num_images: int | None = None, rays_per_image: int | None = None,
                      mesh=None):
    """Train-step body (run_nerf_acc.py:263-328). Returns
    ``train_step(state, rays) -> (state, metrics, pred_pixels,
    target_pixels)``; ``train_step.step_core(state, batch)`` runs one step
    on a given batch. Parameter gradients stay in ``.grad`` after the
    step. The grids are updated in place, and the lr and BARF alpha are
    computed on the device from ``state.step_dev``.

    ``sample_mode='image'`` (run_nerf_acc.py:279-280) draws the batch from
    one random view and needs num_images / rays_per_image; ``pose_refine``
    adds the view shifts to the batch's origins. With ``mesh`` (a 1-D
    ``DeviceMesh``) each rank steps its share of the batch and the
    gradients are reduced over the mesh (``_sharded_loss_and_grads``); the
    grid update, the draws and the Adam step run whole on every rank."""
    if cfg.sample_mode == "image" and not (num_images and rays_per_image):
        raise ValueError("sample_mode='image' needs num_images and rays_per_image")
    use_fused_step = _fused_step_eligible(model, cfg)
    compacting = 0 < cfg.compact_samples < cfg.depth_samples_per_ray

    def sample_batch(state: TrainState, rays: RayDataset) -> RayBatch:
        # ray sampling on the device (run_nerf_acc.py:275-280)
        if cfg.sample_mode == "image":
            return sample_image_rays(state.generator, rays, cfg.img_sample_size, num_images,
                                     rays_per_image)
        return sample_pixel_rays(
            state.generator, rays, cfg.img_sample_size,
            weighted=cfg.sampling_strategy != "random", impl=cfg.sampling_impl,
        )

    def step_core(state: TrainState, batch: RayBatch):
        # the step's stages, each an annotate span (a CUDA graph of the step
        # times them on every replay, training/graph.py): step/sample,
        # step/grid, step/march, step/mlp_fwd, step/composite, step/backward
        # (step/mlp_bwd inside it), step/optimizer; the fused step's
        # march-and-gradient step/fused, the sharded step's step/allreduce
        with annotate("step/grid"):
            # BARF alpha anneal (run_nerf_acc.py:268-272), from the device
            # step counter at every call
            barf_alpha = barf_alpha_of(cfg, state.step_dev)
            # occupancy EMA updates every n steps (run_nerf_acc.py:285-286),
            # one shared sigma pass for both grids, written into the state's
            # grids
            grid, vessel_grid = every_n_step_pair(
                state.grid, state.vessel_grid, state.step,
                _sigma_fn(model, barf_alpha, cfg.mlp_backend),
                cfg.alpha_thre, cfg.vessel_alpha_thre,
                cfg.grid_update_every, cfg.grid_ema_decay,
                generator=state.generator if cfg.grid_jitter else None,
                slabs=cfg.grid_update_slabs,
            )
        state.optimizer.zero_grad(set_to_none=True)
        if mesh is not None:
            loss, pixels, pressure = _sharded_loss_and_grads(
                model, grid, batch, cfg, near, far, barf_alpha, use_fused_step, mesh)
        elif use_fused_step:
            with annotate("step/fused"):
                loss, pixels, march, grads = _fused_loss_and_grads(
                    model, grid, batch.origins, batch.directions, batch.pixel_values, cfg,
                    near, far,
                )
                _set_grads(model, grads)
        else:
            if cfg.pose_refine:
                with annotate("step/sample"):
                    origins = shifted_origins(model, batch)
            else:
                origins = batch.origins
            pixels, _, _, march = render_rays(
                model, grid, origins, batch.directions, cfg, near, far, barf_alpha,
                return_march=True,
            )
            with annotate("step/composite"):
                loss = torch.mean((pixels - batch.pixel_values) ** 2)
            with annotate("step/backward"):
                loss.backward()
        with annotate("step/composite"):
            if mesh is None:
                # a compacted step reports its truncation pressure; the loop
                # reads it at the chunk boundary (training/loop.py)
                pressure = march_pressure(march) if compacting else {}
            loss = loss.detach()
            pixels = pixels.detach()
            metrics = {
                "loss/train-pixel-coarse": loss,
                "psnr/train-coarse": psnr_from_mse(loss),
                "mean/train-pred-coarse": pixels.mean(),
                "mean/train": batch.pixel_values.mean(),
                "barf-coarse": barf_alpha,
                **pressure,
            }
        with annotate("step/optimizer"):
            state.scheduler.apply(state.step_dev)
            if cfg.pose_refine:  # the view shifts' group (make_optimizer)
                state.optimizer.param_groups[1]["lr"].copy_(pose_lr_at(cfg, state.step_dev))
            state.optimizer.step()
            state.advance()
        return state, metrics, pixels, batch.pixel_values

    def train_step(state: TrainState, rays: RayDataset):
        with annotate("step/sample"):
            batch = sample_batch(state, rays)
        return step_core(state, batch)

    train_step.step_core = step_core
    return train_step


def make_train_step(model: CPPN, cfg: TrainConfig, near: float, far: float,
                    num_images: int | None = None, rays_per_image: int | None = None,
                    mesh=None):
    """The single train step (eager; see _build_train_step)."""
    return _build_train_step(model, cfg, near, far, num_images, rays_per_image, mesh)


def accumulate_pressure(acc: torch.Tensor, metrics: dict) -> None:
    """acc (5,) int32 <- the elementwise max of acc and a compacted step's
    pressure scalars (PRESSURE_KEYS order); a dense step reports none. Over
    a chunk from 0 it is the JAX loop's ``_pressure_stats`` of the chunk
    (every scalar is >= 0)."""
    if "march/over_k" in metrics:
        torch.maximum(acc, torch.stack([metrics[k] for k in PRESSURE_KEYS]), out=acc)


def make_train_chunk(model: CPPN, cfg: TrainConfig, near: float, far: float,
                     steps_per_call: int, pool=None, pressure: torch.Tensor | None = None,
                     num_images: int | None = None, rays_per_image: int | None = None,
                     mesh=None):
    """``steps_per_call`` train steps in one call (the JAX package's
    make_train_chunk, a jitted lax.scan): ``chunk(state, rays) -> (state,
    metrics, pred, target)`` of the last step (the JAX loop reads the last
    of its stacked metrics), with ``chunk.pressure`` the running max of the
    steps' truncation pressure. On the card each step is one replay of a
    CUDA graph captured for its grid-update kind; on the CPU it is the eager
    step (training/graph.py). ``pool``: a CUDA graph memory pool shared
    with other chunks; ``pressure``: the (5,) int32 buffer to reduce into
    (default: the chunk's own); ``num_images`` / ``rays_per_image`` and
    ``mesh``: as make_train_step. Under an NCCL mesh each captured step
    holds its all-reduces (the warm-up step of each kind runs them eagerly
    first); a gloo mesh runs on the CPU, whose steps are eager."""
    step = _build_train_step(model, cfg, near, far, num_images, rays_per_image, mesh)

    def body(state, rays, acc):
        out = step(state, rays)
        with annotate("step/composite"):
            accumulate_pressure(acc, out[1])
        return out

    def kind_of(state) -> int | str | None:
        return grid_update_kind(state.step, state.grid.resolution, cfg.grid_update_every,
                                cfg.grid_update_slabs)

    return TrainChunk(body, kind_of, steps_per_call, pool=pool, pressure=pressure)


def make_eval_step(model: CPPN, cfg: TrainConfig, near: float, far: float):
    """Held-out view evaluation (run_nerf_acc.py:330-380): full-image MSE,
    PSNR and vessel-pixel PSNR, at the BARF alpha of the state's step."""

    @torch.no_grad()
    def eval_step(state: TrainState, test: TestView):
        pixels, _, _ = render_rays(
            model, state.grid, test.origins, test.directions, cfg, near, far,
            barf_alpha_of(cfg, state.step_dev),
        )
        mse = torch.mean((pixels - test.pixel_values) ** 2)
        vessel = test.vessel_mask.to(torch.float32)
        vessel_mse = ((pixels - test.pixel_values) ** 2 * vessel).sum() / torch.clamp(
            vessel.sum(), min=1.0
        )
        return {
            "loss/test-pixel-coarse": mse,
            "psnr/test-coarse": psnr_from_mse(mse),
            "psnr/vessel-test-coarse": psnr_from_mse(vessel_mse),
        }, pixels

    return eval_step
