"""Evaluation and export driver in torch (port of
``nerf_for_angiography_tpu/evaluation/sweep.py``; the reference's
``visualization/visualization.py``).

Renders the trained field over a dense angle sweep (37x37 views,
ref :63-65,188-191), scores each view, and exports:
  * per-view pred / binary-pred PNGs (:399-400), written by the port's own
    grayscale PNG writer (``utils/png.py``);
  * df-metrics.csv with the reference's schema, written with ``csv``
    (``;``-separated, pandas' unnamed index column first), and the
    min/mean/std summary (:456-535);
  * a dense 3D field VTK (a 201^3 query lattice through the model, :203-238);
  * theta/phi rotation videos (:537-546);
  * polar heatmap PNGs and the cag-vis JSONs (:572-657 via heatmap.py).

The results are a column table: a dict from the JAX DataFrame's column
names, in its order, to numpy arrays with one row a view (``pred_img``,
``binary_pred_img`` and ``org_img`` as (N, H*W) float32 arrays).

Views render in batches of ``chunk_views``: the batch's rays go through one
march and one MLP call (kernel #1 on the card, with first-k, kernel #5, in
the CT branch's compacted lattice march), and each batch is scored on the
device in one call per metric. The sweep runs on the card unless called
with ``device="cpu"``.

With ``mesh`` (a 1-D ``DeviceMesh``) the views are padded to a multiple of
``chunk_views`` times the mesh's size, and each rank renders and scores
``chunk_views`` of each such batch: the same groups of views one process
renders, so every view's pixels and scores are the ones one process
computes. The pixels and the per-view metric rows are gathered to every
rank, each rank computes the field, and only the coordinator (rank 0)
writes the CSV, PNGs, VTK, videos and JSONs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import get_ray_values, linspace_depths, query_points
from ..models import CPPN
from ..ops.interpolation import RegularGrid
from ..ops.occupancy import OccupancyGrid
from ..parallel import collectives, is_coordinator
from ..parallel.mesh import mesh_coords
from ..training.config import TrainConfig
from ..training.train import density_raw, render_rays_with_binary
from ..utils.csvtable import write_csv_table
from ..utils.png import write_png_unit
from ..utils.vtk import write_structured_grid
from .heatmap import _get_2d_heatmap, experiment_naming, normalize_cam_poses
from .metrics import (
    binarize,
    dice_micro,
    dice_micro_views,
    dot_score,
    dot_score_views,
    psnr_views,
    ssim,
)
from .video import get_videos

METRIC_COLUMNS = (
    "PSNR", "SSIM", "LPIPS", "DISTS", "DICE 2D", "DOT 2D", "DICE 3D", "DOT 3D",
)
_IMAGE_COLUMNS = ("pred_img", "binary_pred_img", "org_img")


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Mirrors visualization.py:33-98 constants per data_name."""

    data_name: str = "ct"
    binary: bool = False
    limited_size_vis: float = 360.0
    number_angles_vis: float = 36.0
    outside: float = 100.0
    focal_length: float = 1300.0
    src_z_offset: float = 200.0  # ct: src=[0,0,f+200]; LCA: [0,0,f]
    img_width: int = 100
    img_height: int = 100
    sample_outside: float = 75.0
    depth_samples_per_ray: int = 200
    chunk_views: int = 4
    # superset of the reference's default list ['DISTS','LPIPS','PSNR']
    # (visualization.py:38): LPIPS/DISTS are computed whenever a perceptual
    # backend is passed to run_sweep; DICE 3D/DOT 3D whenever a GT volume
    # sampler is passed (visualization.py:480-505).
    metrics: tuple = (
        "PSNR", "SSIM", "DICE 2D", "DOT 2D", "DICE 3D", "DOT 3D",
        "LPIPS", "DISTS",
    )
    binary_thresh: float = 0.05  # visualization.py:172
    field_resolution: int = 201  # visualization.py:102 (200+1)
    save_vtk: bool = True
    save_videos: bool = True
    save_heatmap: bool = True
    # None = export heatmap JSONs for EVERY computed per-view metric, so
    # every metric radio in cag-vis resolves; a tuple restricts the set.
    heatmap_metrics: tuple | None = None
    center_point: tuple = (90.0, 0.0)

    @property
    def src_pt(self):
        return np.array([0.0, 0.0, self.focal_length + self.src_z_offset], np.float32)

    @property
    def near_thresh(self) -> float:
        return float(self.src_pt[2] - self.sample_outside)

    @property
    def far_thresh(self) -> float:
        return float(self.src_pt[2] + self.sample_outside)


def lca_eval_config(**kw) -> EvalConfig:
    """LCA preset (visualization.py:86-98)."""
    base = dict(
        data_name="LCA", focal_length=4000.0, src_z_offset=0.0, img_width=150,
        img_height=162, sample_outside=80.0, outside=80.0,
        depth_samples_per_ray=200,
    )
    base.update(kw)
    return EvalConfig(**base)


def sweep_angles(cfg: EvalConfig) -> np.ndarray:
    """37x37 view grid (visualization.py:188-191), float64."""
    step = cfg.limited_size_vis / cfg.number_angles_vis
    th = np.arange(
        -cfg.limited_size_vis // 2, cfg.limited_size_vis // 2 + 1, step
    ).astype("float64")
    return np.array([list(v) for v in itertools.product(th, th)])


def _angles_360(angles: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Negative angles wrapped to [0, 360) (visualization.py:280-281)."""
    t360 = np.where(angles[:, 0] >= 0, angles[:, 0], 360 + angles[:, 0])
    p360 = np.where(angles[:, 1] >= 0, angles[:, 1], 360 + angles[:, 1])
    return t360, p360


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_device(device, model: CPPN, grid: OccupancyGrid | None = None) -> torch.device:
    """The sweep's device (the card unless ``device="cpu"``); the model and
    the grid must already be there."""
    dev = resolve_device(device)
    held = [("model", next(model.parameters()).device)]
    if grid is not None:
        held.append(("grid", grid.occs.device))
    for what, d in held:
        if d.type != dev.type:
            raise ValueError(f"the {what} is on {d}, the sweep runs on {dev}: move it there "
                             f"or pass device='{d.type}'")
    return dev


def gt_from_volume(volume: RegularGrid, cfg: EvalConfig) -> Callable:
    """GT DRR provider on the volume's device (replaces the PNG reads at
    visualization.py:285-287): renders with the datagen pipeline and the
    sweep's camera intrinsics, mode 'sdf' unless data_name is 'ct'."""
    from ..data.drr import render_drr

    dev = volume.values.device
    depths = linspace_depths(cfg.near_thresh, cfg.far_thresh, cfg.depth_samples_per_ray,
                             device=dev)
    mode = "sdf" if cfg.data_name != "ct" else "ct"

    @torch.no_grad()
    def gt(theta_360: float, phi_360: float) -> np.ndarray:
        o, d, _ = get_ray_values(
            theta_360, phi_360, 0.0, cfg.src_pt, cfg.img_width, cfg.img_height,
            cfg.focal_length, device=dev,
        )
        return _host(render_drr(volume, o, d, depths, mode))

    return gt


def _view_render_fn(model: CPPN, grid_template: OccupancyGrid, cfg: EvalConfig):
    """The batch render closure: (grid, thetas, phis) (B,) in degrees ->
    (pixels (B, H*W), binary pixels (B, H*W), cam2world (B, 4, 4)) on the
    grid's device.

    The B views' rays are concatenated into one batch: ct marches it once
    (the compacted lattice march, first-k on the card) and evaluates the
    MLP once; LCA queries the MLP once at every linspace depth. The march,
    first-k, the MLP and the composite all work per ray (or per point), so
    each view's pixels are the ones a render of that view alone gives,
    which is what the JAX package's vmap over views computes."""
    tc = TrainConfig(
        depth_samples_per_ray=cfg.depth_samples_per_ray,
        outside=cfg.outside,
        alpha_thre=1e-4,
        early_stop_eps=1e-2,
        # the safe_occ_stride guard needs the REAL loaded grid resolution,
        # not the training default
        grid_resolution=int(grid_template.resolution),
        # eval has no auto-switch guard against window truncation: keep the
        # exact per-sample lattice masking here
        march_mode="lattice",
    )
    near, far = cfg.near_thresh, cfg.far_thresh

    @torch.no_grad()
    def render(grid: OccupancyGrid, thetas, phis):
        dev = grid.occs.device
        rays = [
            get_ray_values(float(t), float(p), 0.0, cfg.src_pt, cfg.img_width, cfg.img_height,
                           cfg.focal_length, device=dev)
            for t, p in zip(thetas, phis)
        ]
        o = torch.cat([r[0].reshape(-1, 3) for r in rays])
        d = torch.cat([r[1].reshape(-1, 3) for r in rays])
        c2w = torch.stack([r[2] for r in rays])
        if cfg.data_name == "ct":
            pixels, bpixels = render_rays_with_binary(
                model, grid, o, d, tc, near, far, binary_thresh=cfg.binary_thresh,
            )
        else:
            depths = linspace_depths(near, far, cfg.depth_samples_per_ray, device=dev)
            raw = density_raw(model, query_points(o, d, depths), 0.0, "auto")
            sigma = torch.sigmoid(raw)
            dists = torch.cat([depths[1:] - depths[:-1],
                               torch.full((1,), 1e10, dtype=torch.float32, device=dev)])
            pixels = torch.exp(-torch.sum(sigma * dists, -1))
            bsigma = torch.where(sigma < cfg.binary_thresh, torch.zeros_like(sigma), sigma)
            bpixels = torch.exp(-torch.sum(bsigma * dists, -1))
        b = len(rays)
        return pixels.reshape(b, -1), bpixels.reshape(b, -1), c2w

    return render


def make_view_renderer(model: CPPN, grid_template: OccupancyGrid, cfg: EvalConfig):
    """One-view renderer reused for every view: (grid, theta_360, phi_360)
    -> (pixels (H*W,), binary pixels (H*W,), cam2world (4, 4))."""
    batch = _view_render_fn(model, grid_template, cfg)

    def render(grid, theta_360, phi_360):
        px, bpx, c2w = batch(grid, [theta_360], [phi_360])
        return px[0], bpx[0], c2w[0]

    return render


def make_batch_view_renderer(model: CPPN, grid_template: OccupancyGrid, cfg: EvalConfig,
                             mesh=None):
    """Batched sweep renderer: (grid, thetas, phis) (B,) -> stacked images
    (see _view_render_fn). With ``mesh`` B must divide over its ranks: each
    renders its contiguous B / size views and every rank gets all B
    (all-gathered)."""
    render = _view_render_fn(model, grid_template, cfg)
    if mesh is None:
        return render
    rank, world = mesh_coords(mesh)

    def sharded(grid, thetas, phis):
        if len(thetas) % world:
            raise ValueError(f"{len(thetas)} views do not divide over {world} ranks")
        per = len(thetas) // world
        mine = slice(rank * per, (rank + 1) * per)
        return tuple(collectives.all_gather_cat(t, mesh)
                     for t in render(grid, thetas[mine], phis[mine]))

    return sharded


def render_view_pair(
    model: CPPN,
    grid: OccupancyGrid,
    cfg: EvalConfig,
    theta_360: float,
    phi_360: float,
    renderer=None,
    device="cuda",
):
    """Pred and binary-pred images (H, W) and cam2world (4, 4) of one view,
    as numpy.

    ct: grid-pruned masked render, binary via zeroing densities below
    binary_thresh (the reference's zero_idx, visualization.py:329-355).
    LCA: dense un-pruned render over linspace depths (:356-397)."""
    _check_device(device, model, grid)
    if renderer is None:
        renderer = make_view_renderer(model, grid, cfg)
    H, W = cfg.img_height, cfg.img_width
    pixels, bpixels, c2w = renderer(grid, theta_360, phi_360)
    return _host(pixels).reshape(H, W), _host(bpixels).reshape(H, W), _host(c2w)


def _padded_angles(angles: np.ndarray, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """(theta_360, phi_360) padded to a multiple of ``batch`` views with
    copies of the last view, which are rendered and dropped (as the JAX
    sweep does)."""
    t360, p360 = _angles_360(angles)
    n = len(angles)
    n_pad = (-n) % batch
    t360 = np.concatenate([t360, np.full(n_pad, t360[-1] if n else 0.0)])
    p360 = np.concatenate([p360, np.full(n_pad, p360[-1] if n else 0.0)])
    return t360, p360


def _render_batches(renderer, grid: OccupancyGrid, angles: np.ndarray, batch: int):
    """Yield (first view, pixels, binary pixels, cam2world) of each batch of
    ``angles`` in input order, the tensors on the device (the padding views
    dropped, ``_padded_angles``)."""
    t360, p360 = _padded_angles(angles, batch)
    n = len(angles)
    for s in range(0, len(t360), batch):
        px, bpx, c2w = renderer(grid, t360[s:s + batch], p360[s:s + batch])
        k = min(batch, n - s)
        yield s, px[:k], bpx[:k], c2w[:k]


def render_sweep_views(
    model: CPPN,
    grid: OccupancyGrid,
    cfg: EvalConfig,
    angles: np.ndarray,
    mesh=None,
    device="cuda",
) -> list:
    """Render every (theta, phi) in ``angles`` with the batched renderer;
    returns [(pred HxW, bpred HxW, c2w 4x4), ...] as numpy in input order.
    With ``mesh`` each rank renders ``chunk_views`` of every batch of
    chunk_views x size views, and every rank returns all of them."""
    _check_device(device, model, grid)
    H, W = cfg.img_height, cfg.img_width
    renderer = make_batch_view_renderer(model, grid, cfg, mesh=mesh)
    batch = max(1, cfg.chunk_views) * mesh_coords(mesh)[1]
    out = []
    for _, px, bpx, c2w in _render_batches(renderer, grid, angles, batch):
        px, bpx, c2w = _host(px), _host(bpx), _host(c2w)
        out += [(px[k].reshape(H, W), bpx[k].reshape(H, W), c2w[k]) for k in range(len(px))]
    return out


def _field_lattice(cfg: EvalConfig) -> tuple[np.ndarray, ...]:
    """The field_resolution^3 query lattice over [-outside, outside]^3 in
    the reference's default 'xy' meshgrid indexing: (gx, gy, gz)."""
    t = np.linspace(-cfg.outside, cfg.outside, cfg.field_resolution, dtype=np.float32)
    return np.meshgrid(t, t, t)


def export_field_vtk(
    model: CPPN, cfg: EvalConfig, path: str | None, chunk: int = 262144, device="cuda"
) -> np.ndarray:
    """Dense 3D field export: query a field_resolution^3 lattice through the
    model in chunks of ``chunk`` points (kernel #1 on the card), write a
    binary StructuredGrid VTK in VTK x-fastest order (visualization.py:
    203-238; nothing is written when ``path`` is None). Returns the field in
    the meshgrid's layout."""
    dev = _check_device(device, model)
    gx, gy, gz = _field_lattice(cfg)
    pts = torch.from_numpy(np.stack([gx, gy, gz], -1).reshape(-1, 3)).to(dev)
    out = np.empty(pts.shape[0], np.float32)
    with torch.no_grad():
        for s in range(0, pts.shape[0], chunk):
            out[s:s + chunk] = _host(torch.sigmoid(density_raw(model, pts[s:s + chunk])))
    if path is None:
        return out.reshape(gx.shape)

    # VTK x-fastest ordering over the meshgrid layout
    vtk_pts = np.stack(
        [gx.transpose(2, 1, 0).ravel(), gy.transpose(2, 1, 0).ravel(),
         gz.transpose(2, 1, 0).ravel()], -1,
    )
    vtk_scalars = out.reshape(gx.shape).transpose(2, 1, 0).ravel()
    write_structured_grid(
        path, vtk_pts, (cfg.field_resolution,) * 3, {"scalars": vtk_scalars},
        binary=True,  # 201^3 points; ASCII is ~100x slower
    )
    return out.reshape(gx.shape)


class _PartClock:
    """Seconds by part into ``timing`` (nothing when it is None), the
    device synchronized at each part's ends so its work is charged to it."""

    def __init__(self, device: torch.device, timing: dict | None):
        self.device, self.timing = device, timing

    @contextlib.contextmanager
    def __call__(self, part: str):
        if self.timing is None:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timing[part] = self.timing.get(part, 0.0) + time.perf_counter() - t0


def write_metrics_csv(table: dict, path: str) -> list[str]:
    """df-metrics.csv: every column but the image rows, ``;``-separated,
    behind the unnamed index column pandas writes. Returns the header."""
    return write_csv_table(table, path, [c for c in table if c not in _IMAGE_COLUMNS])


def export_heatmaps(
    table: dict,
    cfg: EvalConfig,
    store_folder_name: str,
    page_data: dict | None = None,
    perceptual=None,
    save_png: bool = True,
) -> list[str]:
    """The sweep's heatmap exports (visualization.py:572-657): cam poses
    normalised in place, then top and bottom X-Z heatmaps of every per-view
    metric (cfg.heatmap_metrics, or all of them) under jsonData/<experiment>/
    <name>, the polar PNGs with ``save_png``. Each per-angle JSON is written
    once (the JAX sweep rewrites the same content once per metric and
    hemisphere). Returns the metrics exported."""
    normalize_cam_poses(table)
    experiment, exp_name = experiment_naming(page_data or {}, cfg.center_point)
    exp_folder = os.path.join(store_folder_name, "jsonData", experiment, exp_name)
    # per-metric color ranges (visualization.py:643-649; everything else
    # defaults to [0,1] incl. LPIPS/DISTS)
    vmm = {"PSNR": (15, 50), "SSIM": (0.8, 1), "DICE 2D": (0.3, 1)}
    # 3D metrics are one scalar per run: a constant heatmap is meaningless,
    # so only per-view metrics export (as the reference does,
    # visualization.py:519,573)
    heat = cfg.heatmap_metrics
    if heat is None:
        heat = [m for m in table if m in METRIC_COLUMNS and m not in ("DICE 3D", "DOT 3D")]
    extra = None
    if perceptual is not None and not perceptual.calibrated:
        extra = {"calibrated": False}
    written: set = set()
    done = []
    for metric in heat:
        if metric not in table:
            continue
        for nm in ("top", "bottom"):
            _get_2d_heatmap(
                table, store_folder_name, exp_folder, nm, "X", "Z", metric,
                vmm.get(metric, (0.0, 1.0)), cfg.center_point, True, save_png,
                extra if metric in ("LPIPS", "DISTS") else None, angles_written=written,
            )
        done.append(metric)
    return done


def run_sweep(
    model: CPPN,
    grid: OccupancyGrid,
    cfg: EvalConfig,
    gt_fn: Callable,
    store_folder_name: str,
    page_data: dict | None = None,
    perceptual=None,
    gt_volume_sampler: Callable | None = None,
    verbose: bool = True,
    mesh=None,
    device="cuda",
    timing: dict | None = None,
) -> dict:
    """Full evaluation of one trained run. Returns the metric column table
    (also written as df-metrics.csv). ``gt_volume_sampler`` takes (P, 3)
    points on the device; ``timing``, when given, is filled with the
    seconds of each part (render, gt, metrics, perceptual, png, vtk, csv,
    video, json; with ``mesh`` also gather, the collectives). With
    ``mesh`` every rank returns the table and only the coordinator writes
    (see the module docstring)."""
    dev = _check_device(device, model, grid)
    rank, world = mesh_coords(mesh)
    writes = mesh is None or is_coordinator()  # the one writer of a sharded sweep
    renderer = make_batch_view_renderer(model, grid, cfg)  # this rank's views
    proj_dir = os.path.join(store_folder_name, "projections")
    if writes:
        os.makedirs(proj_dir, exist_ok=True)
    clock = _PartClock(dev, timing)
    if perceptual is not None:
        perceptual = perceptual.to(dev)

    angles = sweep_angles(cfg)
    n, H, W = len(angles), cfg.img_height, cfg.img_width
    t360, p360 = _angles_360(angles)
    want = set(cfg.metrics)
    names = [m for m in ("PSNR", "SSIM", "DICE 2D", "DOT 2D") if m in want]
    if perceptual is not None:
        names += [m for m in ("LPIPS", "DISTS") if m in want]
    scores = {m: np.empty(n, np.float64) for m in names}
    pred_img = np.empty((n, H * W), np.float32)
    bpred_img = np.empty((n, H * W), np.float32)
    org_img = np.empty((n, H * W), np.float32)
    cam = np.empty((n, 3), np.float32)

    cv = max(1, cfg.chunk_views)
    t_pad, p_pad = _padded_angles(angles, cv * world)
    for s0 in range(0, len(t_pad), cv * world):
        # this rank's chunk_views views of the batch, and the real ones among them
        s = s0 + rank * cv
        k = min(max(n - s, 0), cv)
        with clock("render"):
            px, bpx, c2w = renderer(grid, t_pad[s:s + cv], p_pad[s:s + cv])
        with clock("gt"):
            target = np.zeros((cv, H, W), np.float32)
            for i in range(k):
                target[i] = np.asarray(gt_fn(t360[s + i], p360[s + i]), np.float32).reshape(H, W)
            tgt = torch.from_numpy(target[:k]).to(dev)
        p3, b3 = px[:k].reshape(-1, H, W), bpx[:k].reshape(-1, H, W)
        got = {}  # a rank whose views in the last batch are all padding scores none
        with clock("metrics"):
            if k and "PSNR" in scores:
                got["PSNR"] = psnr_views(p3, tgt)
            if k and "SSIM" in scores:
                got["SSIM"] = ssim(p3, tgt)
            if k and "DICE 2D" in scores:
                got["DICE 2D"] = dice_micro_views(binarize(b3), binarize(tgt))
            if k and "DOT 2D" in scores:
                got["DOT 2D"] = dot_score_views(p3, tgt)
        with clock("perceptual"):
            if k and "LPIPS" in scores:
                got["LPIPS"] = perceptual.lpips(p3, tgt)
            if k and "DISTS" in scores:
                got["DISTS"] = perceptual.dists(p3, tgt)
        # this rank's views: the images and cam2world (f32) and the metric
        # rows (f64, the table's type); with a mesh, every rank's, in view
        # order
        rows = torch.zeros((cv, len(names)), dtype=torch.float64, device=dev)
        for j, m in enumerate(names):
            if m in got:
                rows[:k, j] = got[m].to(torch.float64)
        img = torch.cat([px.reshape(cv, -1), bpx.reshape(cv, -1),
                         torch.from_numpy(target.reshape(cv, -1)).to(dev),
                         c2w.reshape(cv, 16)], dim=1)
        if mesh is not None:
            with clock("gather"):
                img, rows = (collectives.all_gather_cat(t, mesh) for t in (img, rows))
        idx = slice(s0, min(s0 + cv * world, n))
        real = idx.stop - idx.start
        with clock("png"):
            img, rows = _host(img), _host(rows)
            for j, m in enumerate(names):
                scores[m][idx] = rows[:real, j]
            pred, bpred, org = (img[:real, q * H * W:(q + 1) * H * W] for q in range(3))
            cam[idx] = img[:real, 3 * H * W:].reshape(-1, 4, 4)[:, :3, -1]
            pred_img[idx] = np.round(pred, 10)
            bpred_img[idx] = np.round(bpred, 10)
            org_img[idx] = org
            for j, (theta, phi) in enumerate(angles[idx] if writes else ()):
                file_image_id = f"image-{theta}-{phi}-0"
                write_png_unit(f"{proj_dir}/{file_image_id}.png", pred[j].reshape(H, W))
                write_png_unit(f"{proj_dir}/{file_image_id}-binary.png", bpred[j].reshape(H, W))
        if verbose and writes and (idx.stop // 100) > (idx.start // 100):
            print(f"  sweep {idx.stop}/{n}")

    table = {
        "image_id": np.array([f"{t}-{p}".replace(".", ",") for t, p in angles], dtype=object),
        "theta": angles[:, 0].copy(),
        "phi": angles[:, 1].copy(),
        "larm": np.zeros(n, np.int64),
        "theta_360": t360,
        "phi_360": p360,
        "cam_pose_x": cam[:, 0].copy(),
        "cam_pose_y": cam[:, 1].copy(),
        "cam_pose_z": cam[:, 2].copy(),
        **scores,
        "pred_img": pred_img,
        "binary_pred_img": bpred_img,
        "org_img": org_img,
    }

    # 3D field export + DICE/DOT 3D (visualization.py:203-238,480-505)
    if cfg.save_vtk or "DICE 3D" in want or "DOT 3D" in want:
        with clock("vtk"):
            field = export_field_vtk(
                model, cfg, os.path.join(store_folder_name, "coarse-field.vtk") if writes
                else None, device=dev)
        if gt_volume_sampler is not None:
            with clock("metrics"):
                gx, gy, gz = _field_lattice(cfg)
                pts = torch.from_numpy(np.stack([gx, gy, gz], -1).reshape(-1, 3)).to(dev)
                with torch.no_grad():
                    gt_field = _host(gt_volume_sampler(pts)).astype(np.float32).reshape(gx.shape)
                if "DICE 3D" in want:
                    thr = gt_field.mean()
                    d3 = float(dice_micro(torch.from_numpy(field >= thr),
                                          torch.from_numpy(gt_field >= thr)))
                    table["DICE 3D"] = np.full(n, d3)
                if "DOT 3D" in want:
                    o3 = float(dot_score(torch.from_numpy(field), torch.from_numpy(gt_field)))
                    table["DOT 3D"] = np.full(n, o3)

    metric_cols = [c for c in table if c in METRIC_COLUMNS]
    # calibration marker for the perceptual columns (uncalibrated = the
    # random-VGG backend; values are self-consistent but not piq-comparable)
    if perceptual is not None and ("LPIPS" in table or "DISTS" in table):
        table["perceptual_calibrated"] = np.full(n, bool(perceptual.calibrated))
    if not writes:
        return table
    with clock("csv"):
        write_metrics_csv(table, os.path.join(store_folder_name, "df-metrics.csv"))

        # min/mean/std summary (visualization.py:519-535)
        summary = {}
        for m in metric_cols:
            v = np.asarray(table[m], float)
            summary[f"{m} min"] = round(float(v.min()), 6)
            summary[f"{m} mean"] = round(float(v.mean()), 6)
            summary[f"{m} std"] = round(float(v.std(ddof=0)), 6)
        with open(os.path.join(store_folder_name, "metrics-summary.txt"), "w") as f:
            for k, v in summary.items():
                f.write(f"{k}={v}\n")

    if cfg.save_videos:
        with clock("video"):
            for title, axis in (("theta-rotation", "phi"), ("phi-rotation", "theta")):
                rows = [{c: table[c][i] for c in _IMAGE_COLUMNS}
                        for i in np.flatnonzero(table[axis] == 0.0)]
                get_videos(rows, title, cfg.img_height, cfg.img_width, proj_dir)

    if cfg.save_heatmap:
        with clock("json"):
            export_heatmaps(table, cfg, store_folder_name, page_data, perceptual)

    return table
