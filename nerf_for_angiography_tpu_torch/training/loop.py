"""Training loop (port of ``nerf_for_angiography_tpu/training/loop.py``;
run_nerf_acc.py's experiment behavior): held-out test view, periodic eval,
best-checkpoint selection on vessel PSNR (plain PSNR for binary/random runs,
run_nerf_acc.py:376) and early stop after ``early_stop_iters`` stale
evaluations (:434-440).

Adaptive compaction as in the JAX loop: dense steps (``compact_samples=0``)
until ``choose_compact_mode`` finds a compacted march that renders the
held-out view losslessly (checked every ``check_every`` iterations,
iteration 0 included), then the compacted stepper at the ``Tuning`` the
pressure tuner sizes (training/pressure.py), re-chosen at the re-check
cadence or when the batch's truncation pressure fires, and a revert to the
dense stepper if nothing fits any more. Eval always renders the dense
lattice. One chunk (``make_train_chunk``) per ``Tuning``, cached.

The loop steps by the JAX loop's chunks: a full chunk of ``chunk_c`` steps
is one call of the current ``Tuning``'s chunk, and a partial chunk,
iteration 0 among them, is a call of the same chunk for fewer steps. On the
card each step is one replay of a CUDA graph captured for its grid-update
kind, after one eager step of that kind (training/graph.py). The JAX loop
runs a partial chunk as single jitted steps because a scan of another
length would compile anew; a graph is one step, so a replay serves any
count, and it equals the eager step bit for bit. All chunks' graphs share
one memory pool. The host waits for the card only at the chunk
boundaries: no step reads the device. The steps' truncation pressure is
reduced on the device into one (5,) int32 running max, reset at the start
of each chunk and copied to the host once per chunk. The tuner sees it with
the JAX loop's latency: a full chunk's pressure waits in a one-entry queue
until the next chunk's steps have been issued, and the queue drains early
only where the JAX loop drains it (before a new step callable's first chunk
or a partial chunk, at a logging boundary when logging, a compaction check,
a re-check boundary, an armed fire, a display boundary and the last
iteration); a partial chunk is observed at once. So a fire in the chunk
ending at 100 retunes at 200 in both loops.

With ``log_dir`` the loop writes the JAX loop's artifacts there:
TensorBoard scalars and images (training/logging.py), the occupancy grids
as VTK at every eval (``grid_export``; written by a background thread from
host copies, the newest write of a name wins), ``highmodel.npz``,
``highgrid.vtk``, ``highvesselgrid.vtk`` and ``readme.txt`` at each new
best, ``coarsemodel.npz`` every ``save_every`` and, with
``checkpoint_every``, the resume state under ``ckpt/``
(training/checkpoint.py) at the evals that fall on its cadence. A run
whose ``log_dir/ckpt`` holds a checkpoint resumes from it at
``state.step``. Neither a resumed run nor one given ``initial_state`` is
carved.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from datetime import datetime
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..ops.occupancy import OccupancyGrid, carve_feasible, with_coarse
from ..ops.sampling import RayDataset, build_sampling_table
from .checkpoint import CheckpointManager, save_grid_vtk, save_model
from .config import TrainConfig, categories_for
from .logging import ExperimentLogger
from .pressure import PressureTuner, Tuning
from .train import (
    TestView,
    choose_compact_mode,
    create_train_state,
    drop_test_view,
    make_eval_step,
    make_test_view,
    make_train_chunk,
)


class _AsyncWriter:
    """Daemon artifact writer: the newest write of a tag wins, and the step
    never waits for it (the two 128^3 grid exports take tenths of a second
    of host time each). Thunks close over host (numpy) data only."""

    def __init__(self):
        self._cv = threading.Condition()
        self._pending: dict[str, Any] = {}
        self._open = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, tag: str, thunk) -> None:
        with self._cv:
            self._pending[tag] = thunk  # a newer write for a tag wins
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._open and not self._pending:
                    self._cv.wait()
                if not self._pending:
                    return
                tag, thunk = self._pending.popitem()
            try:
                thunk()
            except Exception as e:  # noqa: BLE001 — an export never stops training
                print(f"async write '{tag}' failed: {e}")

    def close(self) -> None:
        """Flush all pending writes and stop the thread."""
        with self._cv:
            self._open = False
            self._cv.notify()
        self._thread.join(timeout=120)


def _grid_snapshot(grid: OccupancyGrid) -> OccupancyGrid:
    """Host copy of a grid's binary and aabb for the async VTK export."""
    b = grid.binary.cpu().numpy()
    return OccupancyGrid(occs=b, binary=b, aabb=grid.aabb.cpu().numpy())


def _assemble_image(test: TestView, pixel_values: torch.Tensor) -> np.ndarray:
    """Scatter per-ray values into the (W, H) test image layout of the
    reference (test_img[x_positions, y_positions], run_nerf_acc.py:97-99)."""
    img = np.zeros((test.img_width, test.img_height), np.float32)
    img[test.x_positions.cpu().numpy(), test.y_positions.cpu().numpy()] = (
        pixel_values.detach().cpu().numpy())
    return img


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


def _sizes(choice, tuning: Tuning) -> str:
    """The verbose lines' sizing, as the JAX loop prints it."""
    return (
        f"{choice.width} -> k={tuning.k}, w_cap={tuning.w_cap}"
        + (f", w_lo={tuning.w_lo}" if tuning.w_lo else "")
        + (f", k_lo={tuning.k_lo}" if tuning.k_lo else "")
    )


def _export_grids(writer: _AsyncWriter, log_dir: str, prefix: str, state) -> None:
    """Queue ``<prefix>grid.vtk`` and ``<prefix>vesselgrid.vtk`` from host
    copies of the state's two grids."""
    for name, grid in (("grid", state.grid), ("vesselgrid", state.vessel_grid)):
        snap = _grid_snapshot(grid)
        path = os.path.join(log_dir, f"{prefix}{name}.vtk")
        writer.submit(f"{prefix}{name}", lambda p=path, g=snap: save_grid_vtk(p, g))


def _write_readme(log_dir: str, page_data: dict, psnr: float, vessel_psnr: float) -> None:
    """readme.txt: the experiment's page_data at the new best, as the JAX
    loop writes it."""
    page_data["Date end"] = datetime.now().astimezone().isoformat()
    page_data["PSNR"] = round(psnr, 2)
    page_data["Vessel PSNR"] = round(vessel_psnr, 2)
    with open(os.path.join(log_dir, "readme.txt"), "w") as f:
        for k, v in page_data.items():
            f.write(f"{k}={v}\n")
        f.write(f"PSNR={psnr} end={datetime.now().astimezone().strftime('%Y-%m-%d-%H%M')}")


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
    checkpoint_every: int | None = None,
    initial_state=None,
    device: str | torch.device = "cuda",
) -> TrainResult:
    """Train one reconstruction. ``rays`` holds every view's pixels; the
    test view (default: the last) is held out (run_nerf_acc.py:84-86).
    near/far = src_pt_z -+ outside (run_nerf_acc.py:131-134).
    ``initial_state`` (a ``TrainState`` of this configuration) replaces the
    fresh state: a warm start, never carved."""
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
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    ckpt_mgr = (CheckpointManager(os.path.join(log_dir, "ckpt"))
                if log_dir and checkpoint_every else None)
    # resume-on-preemption: the restored state replaces the carved one in
    # the JAX loop, so a run that resumes does not carve
    resume = ckpt_mgr is not None and ckpt_mgr.latest_step() is not None
    if initial_state is not None:  # warm start / state injection
        state = initial_state
        model = state.model
    elif cfg.carve_init and not cfg.pose_refine and not resume:
        # space-carving grid init from the TRAIN rays only (no test leakage)
        feas = carve_feasible(
            train_rays.origins, train_rays.directions, train_rays.pixel_values,
            state.grid.aabb, cfg.grid_resolution, near, far, thresh=cfg.carve_thresh,
        )
        if verbose:
            print(f"carve_init: {1.0 - float(feas.float().mean()):.1%} of cells carved")
        # the coarse table is rebuilt with the carved binary
        state.grid = with_coarse(
            state.grid._replace(feasible=feas, binary=state.grid.binary & feas)
        )
        vfeas = feas.clone()
        state.vessel_grid = with_coarse(
            state.vessel_grid._replace(feasible=vfeas, binary=state.vessel_grid.binary & vfeas)
        )

    model_definition = cfg.model_config().to_model_definition()
    # the dense stepper and eval always march the dense lattice
    dense_cfg = dataclasses.replace(cfg, compact_samples=0)
    eval_step = make_eval_step(model, dense_cfg, near, far)

    # adaptive empty-space skipping: once the grid has pruned far enough
    # that a compacted march renders the held-out view losslessly, switch
    # to the compacted stepper the chooser picks, sized by the tuner. One
    # chunk per Tuning, cached (a retune may revisit one; the key None is
    # the dense stepper's).
    want_compact = 0 < cfg.compact_samples < cfg.depth_samples_per_ray
    using_compact = False
    tuning = Tuning()  # the engaged compacted-stepper sizing (cache key)
    chunkers: dict[Tuning | None, Any] = {}

    # steps between boundaries, as the JAX loop's scan chunks
    chunk_c = math.gcd(100, cfg.display_every)
    if checkpoint_every:
        chunk_c = math.gcd(chunk_c, checkpoint_every)
    # one CUDA graph memory pool for every chunk's graphs, and the running
    # max of the steps' pressure (JAX _pressure_stats), reset each chunk
    pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
    pressure = torch.zeros((5,), dtype=torch.int32, device=device)

    def runner():
        """The engaged stepper's chunk."""
        key = tuning if using_compact else None
        run = chunkers.get(key)
        if run is None:
            step_cfg = dataclasses.replace(
                cfg, march_mode=tuning.mode, compact_samples=tuning.k,
                hybrid_w_cap=tuning.w_cap, hybrid_w_lo=tuning.w_lo, hybrid_k_lo=tuning.k_lo,
            ) if using_compact else dense_cfg
            run = chunkers[key] = make_train_chunk(
                model, step_cfg, near, far, chunk_c, pool=pool, pressure=pressure,
                num_images=n_views - 1, rays_per_image=rays_per_view)
        return run

    # compaction-readiness cadence, rounded up to a chunk boundary so the
    # check fires (the loop only observes boundary iterations)
    if chunk_c > 1:
        check_every = max(chunk_c, -(-cfg.compact_check_every // chunk_c) * chunk_c)
    else:
        check_every = max(1, cfg.compact_check_every)

    writer = _AsyncWriter() if log_dir else None
    page_data = build_page_data(cfg, datetime.now().astimezone().strftime("%Y-%m-%d-%H%M"))
    logger = ExperimentLogger(log_dir) if log_dir else None
    start_iter = 0
    if resume:
        state = ckpt_mgr.restore(state)
        start_iter = int(state.step)
        if verbose:
            print(f"resumed from checkpoint at step {start_iter}")

    highest_psnr = -np.inf
    highest_iter = start_iter
    best_heldout = float("nan")
    last_psnr = float("nan")
    rays_done = 0
    batch = cfg.img_sample_size
    # "compile" = the first step of each chunk, its graph captures and the
    # first eval (kernel builds and first launches; the JAX loop charges its
    # first compiled chunk);
    # "step_dense" / "step_compact" = every other step, synchronized at the
    # chunk boundaries
    timing = {
        "step_dense": 0.0, "step_compact": 0.0, "compile": 0.0,
        "eval": 0.0, "choose": 0.0, "log": 0.0, "export": 0.0,
    }
    seen_chunks: set[int] = set()
    first_eval = True
    dense_rays = 0  # rays stepped by the dense stepper
    compact_steady_rays = 0  # compacted rays outside first steps
    # per-Tuning [steady wall, steady rays, steps (the first one included)]
    steady_phases: dict[Tuning, list] = {}
    # truncation-pressure tuner (training/pressure.py)
    tuner = PressureTuner(display_every=cfg.display_every)
    # a full chunk's (boundary, host copy of its reduced pressure), not yet
    # observed (JAX loop.py:411-475)
    pending: tuple[int, torch.Tensor] | None = None

    def drain() -> None:
        nonlocal pending
        if pending is not None:
            tuner.observe(pending[0], *pending[1].tolist())
            pending = None

    t_start = time.perf_counter()

    n_iter = start_iter
    metrics: dict = {}
    while n_iter <= cfg.n_iters:
        # run up to (and including) the next boundary iteration
        m = min(-(-n_iter // chunk_c) * chunk_c, cfg.n_iters)
        count = m - n_iter + 1
        full_chunk = chunk_c > 1 and count == chunk_c
        chunk = runner()
        first = id(chunk) not in seen_chunks
        if first or not full_chunk:
            drain()  # a new step callable's first chunk, a partial chunk
        seen_chunks.add(id(chunk))
        t0 = time.perf_counter()
        compiled = chunk.compile_s
        state, metrics, pred_pix, target_pix = chunk(state, train_rays, count)
        # one device-to-host copy per chunk (a copy on the CPU too: the next
        # chunk reuses the buffer), complete after the boundary's synchronize
        stats = (pressure.to("cpu", non_blocking=True, copy=True)
                 if "march/over_k" in metrics else None)  # a compacted step (k < depth)
        _sync(device)
        dt = time.perf_counter() - t0
        compiled = chunk.compile_s - compiled  # its first step and its captures
        timing["compile"] += compiled
        dt -= compiled
        steady = count - 1 if first else count
        if using_compact:
            timing["step_compact"] += dt
            compact_steady_rays += steady * batch
            ph = steady_phases.setdefault(tuning, [0.0, 0, 0])
            ph[0] += dt
            ph[1] += steady * batch
            ph[2] += count
        else:
            timing["step_dense"] += dt
            dense_rays += count * batch
        rays_done += count * batch
        n_iter = m
        # the previous full chunk is observed now that this one is issued;
        # this one waits, unless it is partial
        drain()
        if stats is not None:
            if full_chunk:
                pending = (m, stats)
            else:
                tuner.observe(m, *stats.tolist())

        # re-check cadence of the engaged compacted stepper: check_every
        # while k is on the interim ladder (above compact_samples),
        # display_every once settled
        recheck = check_every if tuning.k > cfg.compact_samples else cfg.display_every
        # drain where a consumer below reads tuner state (JAX loop.py:528-538)
        if (
            (logger is not None and n_iter % 100 == 0)
            or (want_compact and not using_compact and n_iter % check_every == 0)
            or (want_compact and using_compact and (n_iter % recheck == 0 or tuner.fire))
            or n_iter % cfg.display_every == 0
            or n_iter >= cfg.n_iters
        ):
            drain()

        if logger and n_iter % 100 == 0:
            t0 = time.perf_counter()
            logger.scalars({k: v for k, v in metrics.items() if k != "barf-coarse"}, n_iter)
            side = (cfg.sample_size, cfg.sample_size)
            logger.train_images(pred_pix.cpu().numpy().reshape(side),
                                target_pix.cpu().numpy().reshape(side), n_iter)
            timing["log"] += time.perf_counter() - t0

        # compaction-readiness check at its own cadence (iteration 0
        # included: with carve_init the grid can fit at once)
        if want_compact and not using_compact and n_iter % check_every == 0:
            t0 = time.perf_counter()
            choice = choose_compact_mode(cfg, state.grid, test.origins, test.directions, near, far)
            timing["choose"] += time.perf_counter() - t0
            if choice is not None:
                tuning = tuner.engage(choice, cfg)
                using_compact = True
                if verbose:
                    print(f"switching to compacted stepper at iter {n_iter} "
                          f"(march_mode={tuning.mode}, needed width/ray {_sizes(choice, tuning)})")

        # re-validate / re-tune the engaged compacted stepper at the re-check
        # cadence, and at once when the batch's pressure fires; revert to
        # the dense stepper if no compacted mode fits the evolved grid
        recheck = check_every if tuning.k > cfg.compact_samples else cfg.display_every
        if want_compact and using_compact and (n_iter % recheck == 0 or tuner.fire):
            before = (tuning, using_compact)
            t0 = time.perf_counter()
            choice = choose_compact_mode(cfg, state.grid, test.origins, test.directions, near, far)
            timing["choose"] += time.perf_counter() - t0
            if choice is None:
                using_compact = False
                if verbose:
                    print(
                        f"reverting to dense stepper at iter {n_iter} "
                        "(no compacted mode fits the evolved grid)"
                    )
            else:
                tuning2 = tuner.retune(tuning, choice, cfg)
                if tuning2 != tuning:
                    tuning = tuning2
                    if verbose:
                        print(f"retuning compacted stepper at iter {n_iter} "
                              f"(march_mode={tuning.mode}, width {_sizes(choice, tuning)})")
            tuner.resolve(n_iter, changed=(tuning, using_compact) != before, recheck=recheck)

        if n_iter % cfg.display_every == 0:
            if using_compact:
                tuner.decay_if_quiet(n_iter)
            t0 = time.perf_counter()
            test_metrics, test_pixels = eval_step(state, test)
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
            if logger and n_iter % (cfg.display_every * 2) == 0:
                t0 = time.perf_counter()
                logger.scalars(test_metrics, n_iter)
                logger.test_images(_assemble_image(test, test_pixels),
                                   _assemble_image(test, test.pixel_values), n_iter)
                timing["log"] += time.perf_counter() - t0

            t_exp = time.perf_counter()
            if log_dir and cfg.grid_export:
                _export_grids(writer, log_dir, "coarse", state)
            if check >= highest_psnr and n_iter > 0:
                highest_psnr = check
                highest_iter = n_iter
                best_heldout = psnr
                if log_dir:
                    save_model(os.path.join(log_dir, "highmodel.npz"), model_definition,
                               state.model,
                               {"step": n_iter, "psnr": psnr, "vessel_psnr": vessel_psnr})
                    _export_grids(writer, log_dir, "high", state)
                    _write_readme(log_dir, page_data, psnr, vessel_psnr)
            if log_dir and n_iter % cfg.save_every == 0:
                save_model(os.path.join(log_dir, "coarsemodel.npz"), model_definition,
                           state.model, {"step": n_iter})
            if ckpt_mgr and n_iter % checkpoint_every == 0 and n_iter > 0:
                ckpt_mgr.save(n_iter, state)
            timing["export"] += time.perf_counter() - t_exp

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
    timing["dense_rays"] = dense_rays
    timing["pressure_fired"] = tuner.fired
    timing["pressure_muted"] = tuner.muted
    timing["decay_bounces"] = tuner.decay_bounces
    timing["steady_rays_per_sec"] = (
        compact_steady_rays / timing["step_compact"] if timing["step_compact"] > 0 else 0.0
    )
    # the stepper sizing the run ended on, and the per-Tuning breakdown
    timing["tuning_final"] = dataclasses.asdict(tuning) if using_compact else None
    timing["steady_phases"] = [
        {**dataclasses.asdict(t), "wall_s": float(w), "rays": int(r), "steps": int(n)}
        for t, (w, r, n) in steady_phases.items()
    ]
    if verbose:
        print(
            "timing breakdown (s): "
            + "  ".join(
                f"{k}={timing[k]:.1f}"
                for k in ("total", "step_dense", "step_compact", "compile", "eval",
                          "choose", "log", "export", "other")
            )
            + f"  steady={timing['steady_rays_per_sec']:.0f} rays/s"
        )
    if writer:
        writer.close()  # flush pending VTK exports before reporting done
    if logger:
        logger.close()
    if ckpt_mgr:
        ckpt_mgr.close()
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
