"""Training step, render and eval in torch (port of the dense-lattice path of
``nerf_for_angiography_tpu/training/train.py``; the reference's hot loop,
nerf/run_nerf_acc.py:263-440).

Per step: sample a ray batch on the device, EMA-update the two occupancy
grids every ``grid_update_every`` steps from one shared sigma pass, march the
dense lattice, evaluate the MLP (the fused kernels on the card), composite
with Beer-Lambert under the early-stop keep mask, take the MSE and apply
Adam with continuous exponential lr decay.

PyTorch runs eagerly, so there is no jit: ``make_train_step`` returns a
plain callable. The state keeps its step counter on the host, so the grid
gate never reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..device import resolve_device
from ..models import CPPN
from ..ops.kernels.fused_mlp import cppn_params_to_list, fused_mlp_raw
from ..ops.occupancy import (
    MarchedRays,
    OccupancyGrid,
    create_grid,
    every_n_step_pair,
    march_rays,
    prune_mask,
    safe_occ_stride,
)
from ..ops.rendering import psnr_from_mse
from ..ops.sampling import RayBatch, RayDataset, sample_pixel_rays
from .config import TrainConfig


def check_ported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for configurations later slices bring."""
    if 0 < cfg.compact_samples < cfg.depth_samples_per_ray:
        raise NotImplementedError(
            "compacted marching (0 < compact_samples < depth_samples_per_ray) arrives "
            "with slice 2; use compact_samples=0 (always-dense lattice)"
        )
    if cfg.march_fka == "pallas":
        raise NotImplementedError("march_fka='pallas' (first-k kernel) arrives with slice 2")
    if cfg.pos_enc in ("fourier", "barf"):
        raise NotImplementedError(f"pos_enc={cfg.pos_enc!r} arrives with slice 4")
    if cfg.fused_train_step != "off":
        raise NotImplementedError("fused_train_step arrives with slice 3")
    if cfg.feature_major_mlp:
        raise NotImplementedError(
            "feature_major_mlp (feature-major kernel input) arrives with slice 3"
        )
    if cfg.pose_refine:
        raise NotImplementedError("pose_refine arrives with the pose-refinement slice")
    if cfg.num_input_channels_views > 0:
        raise NotImplementedError("the view branch arrives with the classic-path slice")
    if cfg.sample_mode != "pixel":
        raise NotImplementedError("sample_mode='image' arrives with the classic-path slice")


@dataclasses.dataclass
class TrainState:
    """The JAX TrainState in PyTorch form: the module owns the parameters,
    the optimizer and scheduler own the Adam state and the lr schedule, the
    step counter lives on the host and ``generator`` replaces the PRNG key."""

    model: CPPN
    optimizer: torch.optim.Optimizer
    scheduler: Any
    grid: OccupancyGrid  # scene grid, alpha_thre=1e-4 (run_nerf_acc.py:197)
    vessel_grid: OccupancyGrid  # vessel grid, 5e-2 (run_nerf_acc.py:198)
    step: int
    generator: torch.Generator


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


def make_optimizer(cfg: TrainConfig, params):
    """Adam (eps 1e-8) with the reference's continuous exponential decay
    lr * 0.1^(step/500k) (run_nerf_acc.py:322-328), as optax's
    exponential_decay(staircase=False) from count 0. ``fused`` updates every
    parameter in one launch: the step is short enough on the card that the
    host's time to issue it counts."""
    opt = torch.optim.Adam(params, lr=cfg.coarse_lr, betas=(0.9, 0.999), eps=1e-8, fused=True)
    rate, steps = cfg.decay_rate, cfg.decay_steps
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: rate ** (s / steps))
    return opt, sched


def create_train_state(
    cfg: TrainConfig, seed: int | None = None, num_views: int | None = None,
    device: str | torch.device = "cuda",
) -> tuple[CPPN, TrainState]:
    """Model, optimizer and the two fresh grids. Weights are drawn on the CPU
    from ``seed`` (default cfg.seed) so they do not depend on the device."""
    check_ported(cfg)
    device = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    init_gen = torch.Generator().manual_seed(seed)
    model = CPPN(cfg.model_config(), generator=init_gen).to(device)
    opt, sched = make_optimizer(cfg, model.parameters())
    aabb = [-cfg.outside] * 3 + [cfg.outside] * 3
    grid = create_grid(aabb, cfg.grid_resolution, device=device)
    vessel_grid = create_grid(aabb, cfg.grid_resolution, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return model, TrainState(
        model=model, optimizer=opt, scheduler=sched, grid=grid, vessel_grid=vessel_grid,
        step=0, generator=gen,
    )


def _pallas_eligible(model: CPPN) -> bool:
    """The fused kernels cover the relu density stack with pos_enc 'none'."""
    c = model.config
    return (
        c.pos_enc == "none"
        and c.act_func == "relu"
        and c.num_late_layers == 0
        and c.num_input_channels == 3
        and c.num_input_channels_views == 0
        and c.num_output_channels == 1
    )


def density_raw(model: CPPN, pts: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Raw 1-channel density at pts (..., 3) -> (...,).

    'pallas' (the JAX package's name for the fused kernels) and 'auto' on an
    eligible model go through ``fused_mlp_raw``: the CUDA kernels for CUDA
    tensors, their plain versions for CPU tensors. 'xla' runs the module's
    own forward."""
    if backend == "pallas" and not _pallas_eligible(model):
        raise ValueError(
            "mlp_backend='pallas' needs pos_enc='none', relu, no view branch/late layers"
        )
    if backend in ("pallas", "auto") and _pallas_eligible(model):
        x = (pts.reshape(-1, 3) * model.config.input_scale).contiguous()
        return fused_mlp_raw(cppn_params_to_list(model), x).reshape(pts.shape[:-1])
    if backend not in ("auto", "xla"):
        raise ValueError(f"unknown mlp_backend {backend!r}")
    return model(pts)[..., -1]


def _sigma_fn(model: CPPN, backend: str = "auto"):
    """Density closure: sigmoid of the raw output (nerf_helpers_acc.py:22-24)."""

    def fn(pts):
        return torch.sigmoid(density_raw(model, pts, backend))

    return fn


def _march_for(cfg, grid, origins, directions, near, far) -> MarchedRays:
    """The dense-lattice march (the compacted marches come with slice 2)."""
    check_ported(cfg)
    return march_rays(
        grid, origins, directions, cfg.depth_samples_per_ray, near, far,
        occ_stride=safe_occ_stride(
            cfg.occ_stride, cfg.depth_samples_per_ray, near, far,
            2 * cfg.outside, cfg.grid_resolution,
        ),
    )


def _flat_positions(m: MarchedRays) -> torch.Tensor:
    return m.positions.reshape(-1, 3)


def _bucket_sigmas(m: MarchedRays, raw: torch.Tensor):
    """[(march, sigma)] for a rectangular march."""
    return [(m, torch.sigmoid(raw).reshape(m.mask.shape))]


def _raw_for(model, m: MarchedRays, cfg: TrainConfig) -> torch.Tensor:
    return density_raw(model, _flat_positions(m), cfg.mlp_backend)


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
    cfg: TrainConfig, near: float, far: float, binary_thresh: float | None = None,
):
    """Grid-pruned masked render of a ray batch, differentiable in the model
    parameters (run_nerf_acc.py:287-296). Returns (pixels, sigma, keep)."""
    m = _march_for(cfg, grid, origins, directions, near, far)
    raw = _raw_for(model, m, cfg)
    ((_, sigma),) = _bucket_sigmas(m, raw)
    dists, keep = _keep_mask(m, sigma, cfg)
    if binary_thresh is not None:
        sigma = torch.where(sigma < binary_thresh, torch.zeros_like(sigma), sigma)
    pixels = torch.exp(-(sigma * keep * dists).sum(dim=-1))
    return pixels, sigma, keep


def _build_train_step(model: CPPN, cfg: TrainConfig, near: float, far: float):
    """Train-step body (run_nerf_acc.py:263-328). Returns
    ``train_step(state, rays) -> (state, metrics, pred_pixels,
    target_pixels)``; ``train_step.step_core(state, batch)`` runs one step
    on a given batch. Parameter gradients stay in ``.grad`` after the
    step."""
    check_ported(cfg)

    def sample_batch(state: TrainState, rays: RayDataset) -> RayBatch:
        return sample_pixel_rays(
            state.generator, rays, cfg.img_sample_size,
            weighted=cfg.sampling_strategy != "random", impl=cfg.sampling_impl,
        )

    def step_core(state: TrainState, batch: RayBatch):
        # occupancy EMA updates every n steps (run_nerf_acc.py:285-286), one
        # shared sigma pass for both grids
        grid, vessel_grid = every_n_step_pair(
            state.grid, state.vessel_grid, state.step,
            _sigma_fn(model, cfg.mlp_backend),
            cfg.alpha_thre, cfg.vessel_alpha_thre,
            cfg.grid_update_every, cfg.grid_ema_decay,
            generator=state.generator if cfg.grid_jitter else None,
            slabs=cfg.grid_update_slabs,
        )
        state.optimizer.zero_grad(set_to_none=True)
        pixels, _, _ = render_rays(
            model, grid, batch.origins, batch.directions, cfg, near, far
        )
        loss = torch.mean((pixels - batch.pixel_values) ** 2)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        loss = loss.detach()
        pixels = pixels.detach()
        metrics = {
            "loss/train-pixel-coarse": loss,
            "psnr/train-coarse": psnr_from_mse(loss),
            "mean/train-pred-coarse": pixels.mean(),
            "mean/train": batch.pixel_values.mean(),
            "barf-coarse": torch.zeros((), device=loss.device),
        }
        state.grid, state.vessel_grid = grid, vessel_grid
        state.step += 1
        return state, metrics, pixels, batch.pixel_values

    def train_step(state: TrainState, rays: RayDataset):
        return step_core(state, sample_batch(state, rays))

    train_step.step_core = step_core
    return train_step


def make_train_step(model: CPPN, cfg: TrainConfig, near: float, far: float):
    """The single train step (eager; see _build_train_step)."""
    return _build_train_step(model, cfg, near, far)


def make_eval_step(model: CPPN, cfg: TrainConfig, near: float, far: float):
    """Held-out view evaluation (run_nerf_acc.py:330-380): full-image MSE,
    PSNR and vessel-pixel PSNR."""

    @torch.no_grad()
    def eval_step(state: TrainState, test: TestView):
        pixels, _, _ = render_rays(
            model, state.grid, test.origins, test.directions, cfg, near, far
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
