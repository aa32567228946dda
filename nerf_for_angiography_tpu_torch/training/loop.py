"""Training driver (port of the dense path of
``nerf_for_angiography_tpu/training/loop.py``; run_nerf_acc.py's experiment
behavior): held-out test view, periodic eval, best-checkpoint selection on
vessel PSNR (plain PSNR for binary/random runs, run_nerf_acc.py:376) and
early stop after ``early_stop_iters`` stale evaluations (:434-440).

The JAX loop's ``lax.scan`` chunks become a Python loop of steps between
the same boundaries; the host waits for the card (``torch.cuda.synchronize``)
only at those boundaries. Checkpoints, TensorBoard logging and VTK export
arrive with the checkpoints/logging slice.
"""

from __future__ import annotations

import dataclasses
import math
import time
from datetime import datetime
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..ops.occupancy import carve_feasible
from ..ops.sampling import RayDataset, build_sampling_table
from .config import TrainConfig, categories_for
from .train import (
    check_ported,
    create_train_state,
    drop_test_view,
    make_eval_step,
    make_test_view,
    make_train_step,
)


@dataclasses.dataclass
class TrainResult:
    state: Any
    best_psnr: float
    best_iter: int
    # held-out PSNR at the best-checkpoint iteration (the shipped model)
    best_heldout_psnr: float
    last_psnr: float
    iters_run: int
    rays_per_sec: float
    page_data: dict
    # wall-clock breakdown of the loop (seconds), the JAX loop's keys
    timing: dict = dataclasses.field(default_factory=dict)


def build_page_data(cfg: TrainConfig, exp_name: str) -> dict:
    """Experiment metadata dict (run_nerf_acc.py:236-251)."""
    sampling = {
        "frangi": "Frangi sampling",
        "segmentation": "Segmentation sampling",
        "random": "Random sampling",
    }[cfg.sampling_strategy]
    return {
        "ID": exp_name,
        "Date start": datetime.now().astimezone().isoformat(),
        "Category": categories_for(cfg),
        "Sparse projections": int((cfg.number_angles + 1) ** 2),
        "Limited projections": int(cfg.limited_size),
        "Translation": "None",
        "Rotation": "None",
        "Data": cfg.data_name.upper(),
        "Binary": cfg.binary,
        "Sampling": [sampling, "AccNeRF"],
        "Model architecture": f"{cfg.num_layers}x{cfg.num_hidden_units}",
        "Positional encoding": cfg.pos_enc.capitalize(),
        "Learning rate": cfg.coarse_lr,
        "Centerpoint": f"({cfg.center_point[0]} {cfg.center_point[1]})",
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(
    cfg: TrainConfig,
    rays: RayDataset,
    src_pt_z: float,
    log_dir: str | None = None,
    test_view_index: int | None = None,
    rays_per_view: int | None = None,
    verbose: bool = True,
    device: str | torch.device = "cuda",
) -> TrainResult:
    """Train one reconstruction. ``rays`` holds every view's pixels; the
    test view (default: the last) is held out (run_nerf_acc.py:84-86).
    near/far = src_pt_z -+ outside (run_nerf_acc.py:131-134)."""
    check_ported(cfg)
    if log_dir is not None:
        raise NotImplementedError(
            "log_dir (checkpoints, logging, VTK export) arrives with the checkpoints/logging slice"
        )
    device = resolve_device(device)
    rays = rays.to(device)
    near = src_pt_z - cfg.outside
    far = src_pt_z + cfg.outside

    if rays_per_view is None:
        n_views = int(rays.image_ids.max()) + 1
        rays_per_view = rays.num_rays // n_views
    else:
        n_views = rays.num_rays // rays_per_view
    if test_view_index is None:
        test_view_index = n_views - 1

    test = make_test_view(rays, test_view_index, rays_per_view)
    train_rays = drop_test_view(rays, test_view_index, rays_per_view)

    # without-replacement sampling needs batch <= dataset
    if cfg.img_sample_size > train_rays.num_rays:
        new_size = int(np.sqrt(train_rays.num_rays))
        print(
            f"warning: batch {cfg.img_sample_size} > {train_rays.num_rays} "
            f"train rays; shrinking sample_size to {new_size}"
        )
        cfg = dataclasses.replace(cfg, sample_size=new_size)

    if cfg.sampling_impl == "overdraw" and cfg.sampling_strategy != "random":
        train_rays = train_rays._replace(sampling_table=build_sampling_table(train_rays.weights))

    model, state = create_train_state(cfg, num_views=n_views, device=device)
    if cfg.carve_init:
        # space-carving grid init from the TRAIN rays only (no test leakage)
        feas = carve_feasible(
            train_rays.origins, train_rays.directions, train_rays.pixel_values,
            state.grid.aabb, cfg.grid_resolution, near, far, thresh=cfg.carve_thresh,
        )
        if verbose:
            print(f"carve_init: {1.0 - float(feas.float().mean()):.1%} of cells carved")
        state.grid = state.grid._replace(feasible=feas, binary=state.grid.binary & feas)
        vfeas = feas.clone()
        state.vessel_grid = state.vessel_grid._replace(
            feasible=vfeas, binary=state.vessel_grid.binary & vfeas
        )

    train_step = make_train_step(model, cfg, near, far)
    eval_step = make_eval_step(model, cfg, near, far)
    # steps between boundaries, as the JAX loop's scan chunks
    chunk_c = math.gcd(100, cfg.display_every)

    page_data = build_page_data(cfg, datetime.now().astimezone().strftime("%Y-%m-%d-%H%M"))
    highest_psnr = -np.inf
    highest_iter = 0
    best_heldout = float("nan")
    last_psnr = float("nan")
    rays_done = 0
    # "compile" = the first call of each runner (here: kernel builds and
    # first launches); "step_dense" = later steps, synchronized at
    # boundaries. The compacted-path keys stay 0 on the dense path.
    timing = {
        "step_dense": 0.0, "step_compact": 0.0, "compile": 0.0,
        "eval": 0.0, "choose": 0.0, "log": 0.0, "export": 0.0,
    }
    first_step = True
    first_eval = True
    t_start = time.perf_counter()

    n_iter = 0
    metrics: dict = {}
    while n_iter <= cfg.n_iters:
        m = min(-(-n_iter // chunk_c) * chunk_c, cfg.n_iters)
        count = m - n_iter + 1
        t0 = time.perf_counter()
        for _ in range(count):
            state, metrics, _, _ = train_step(state, train_rays)
        _sync(device)
        timing["compile" if first_step else "step_dense"] += time.perf_counter() - t0
        first_step = False
        rays_done += count * cfg.img_sample_size
        n_iter = m

        if n_iter % cfg.display_every == 0:
            t0 = time.perf_counter()
            test_metrics, _ = eval_step(state, test)
            psnr = float(test_metrics["psnr/test-coarse"])
            vessel_psnr = float(test_metrics["psnr/vessel-test-coarse"])
            timing["compile" if first_eval else "eval"] += time.perf_counter() - t0
            first_eval = False
            last_psnr = psnr
            check = psnr if cfg.binary or cfg.sampling_strategy == "random" else vessel_psnr
            if verbose:
                it_time = (time.perf_counter() - t_start) / max(n_iter, 1)
                print(
                    f"Iteration: {n_iter}  Loss coarse: "
                    f"{float(test_metrics['loss/test-pixel-coarse']):.6f}  "
                    f"PSNR coarse: {psnr:.3f}  Vessel coarse: {vessel_psnr:.3f}  "
                    f"({it_time*1000:.2f} ms/iter)"
                )
            if check >= highest_psnr and n_iter > 0:
                highest_psnr = check
                highest_iter = n_iter
                best_heldout = psnr
            if n_iter - highest_iter >= cfg.early_stop_iters:
                if verbose:
                    print(f"Early stop = {n_iter}")
                break
        n_iter += 1

    elapsed = time.perf_counter() - t_start
    timing["total"] = elapsed
    timing["other"] = max(0.0, elapsed - sum(
        timing[k] for k in ("step_dense", "step_compact", "compile", "eval", "choose",
                            "log", "export")
    ))
    timing["dense_rays"] = rays_done
    timing["pressure_fired"] = 0
    timing["pressure_muted"] = 0
    timing["decay_bounces"] = 0
    timing["steady_rays_per_sec"] = 0.0  # compacted-phase rate; dense path has none
    timing["tuning_final"] = None
    timing["steady_phases"] = []
    if verbose:
        print(
            "timing breakdown (s): "
            + "  ".join(
                f"{k}={timing[k]:.1f}"
                for k in ("total", "step_dense", "step_compact", "compile", "eval",
                          "choose", "log", "export", "other")
            )
        )
    return TrainResult(
        state=state,
        best_psnr=float(highest_psnr),
        best_iter=int(highest_iter),
        best_heldout_psnr=float(best_heldout),
        last_psnr=float(last_psnr),
        iters_run=int(min(n_iter, cfg.n_iters)),
        rays_per_sec=float(rays_done / elapsed) if elapsed > 0 else 0.0,
        page_data=page_data,
        timing={k: (float(v) if isinstance(v, float) else v) for k, v in timing.items()},
    )
