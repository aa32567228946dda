"""Dataset synthesis and the CSV data contract (port of
``nerf_for_angiography_tpu/data/datasets.py``; the reference's
phantomdata/cttoray.py and sdftoray.py flows).

``generate_dataset`` covers the CT sweep (cttoray.py), the SDF/LCA sweep
(sdftoray.py: ``angle_mode='sdf'``, ``mode='sdf'`` DRRs,
``per_image_normalize``, and ``resize_to`` at identity) and the pose-shift
augmentation (cttoray.py:194-206: a random rotation and translation a view
but the test view, with ``rays_from_nominal`` the rays of the unshifted
camera).
The two CSV artifacts are written without pandas, byte for byte as the JAX
package's ``to_csv`` writes them (utils/csvtable.py), and ``load_data``
reads them back: the per-ray table through the native loader
(``native/csv_loader.cpp``), or with ``use_native=False`` through the
``csv`` module.
"""

from __future__ import annotations

import dataclasses
import itertools
from ast import literal_eval
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import get_ray_values, linspace_depths, stratify_depths
from ..ops.interpolation import RegularGrid
from ..ops.sampling import RayDataset
from ..utils.csvtable import read_csv_table, write_csv_table
from .drr import render_drr
from .weights import get_weighted_img


@dataclasses.dataclass(frozen=True)
class DatagenConfig:
    """Mirrors cttoray.py module constants + CLI flags (cttoray.py:16-69)."""

    limited_size: float = 360.0
    number_angles: float = 72.0
    center_point: tuple[float, float] = (90.0, 0.0)
    binary: bool = False
    sampling_strategy: str = "frangi"  # frangi | segmentation | random
    focal_length: float = 1300.0
    src_z_offset: float = 200.0  # src_pt = [0, 0, focal + offset] (cttoray.py:59)
    sample_outside: float = 210.0
    img_width: int = 100
    img_height: int = 100
    larm: float = 0.0
    custom_angle: tuple[float, float] = (135.0, 135.0)
    frangi_alpha: float = 0.5  # cttoray.py:50-52 (binary -> 12)
    frangi_beta: float = 0.5
    stratified_depths: bool = True
    mode: str = "ct"  # 'ct' | 'sdf' (DRR compositing, helpers.py:208-213)
    # camera-optimization data augmentation (cttoray.py:38-43,194-206):
    # random angular shift in degrees and translation as a fraction of the
    # max grid dimension, applied to every view except the custom test one
    max_shift_rotation: float = 0.0
    max_shift_translation: float = 0.0
    # pose-refinement scenario: rays from the NOMINAL (unshifted) camera,
    # pixels from the shifted (true) render (TrainConfig.pose_refine)
    rays_from_nominal: bool = False
    # sdftoray.py differences (SURVEY.md section 2.7):
    angle_mode: str = "ct"  # 'ct': centered grid; 'sdf': arange(0, limited+1)
    per_image_normalize: bool = False  # sdftoray.py:125-127
    resize_to: tuple[int, int] | None = None  # (H, W) post-resize (sdftoray.py:132-133)

    @property
    def src_pt(self) -> np.ndarray:
        return np.array([0.0, 0.0, self.focal_length + self.src_z_offset], np.float32)

    @property
    def near_thresh(self) -> float:
        return float(self.src_pt[2] - self.sample_outside)

    @property
    def far_thresh(self) -> float:
        return float(self.src_pt[2] + self.sample_outside)

    @property
    def depth_samples_per_ray(self) -> int:
        return int(self.sample_outside * 2)  # cttoray.py:63


def angle_grid(
    limited_size: float, number_angles: float, center_point=(90.0, 0.0),
    custom_angle=(135.0, 135.0),
) -> np.ndarray:
    """The theta x phi C-arm sweep + one custom test angle, with the
    reference's quirks (cttoray.py:79-105): the center offset applies to
    positive components only, and angles > 180 wrap by subtracting 180."""
    theta_rot = center_point[0] if center_point[0] > 0 else 0.0
    phi_rot = center_point[1] if center_point[1] > 0 else 0.0
    if number_angles > 0:
        step = limited_size / number_angles
        th = np.arange(-limited_size // 2, limited_size // 2 + 1, step) + theta_rot
        ph = np.arange(-limited_size // 2, limited_size // 2 + 1, step) + phi_rot
        th[th > 180] = th[th > 180] - 180
        ph[ph > 180] = ph[ph > 180] - 180
        angles = np.array([list(v) for v in itertools.product(th, ph)])
    else:
        angles = np.array([[90.0, 0.0], [0.0, 90.0]])
    return np.append(angles, [list(custom_angle)], axis=0)


def sdf_angle_grid(
    limited_size: float, number_angles: float, custom_angle=(112.5, 112.5)
) -> np.ndarray:
    """The SDF/LCA sweep: arange(0, limited+1, step) x same + one custom
    test angle (sdftoray.py:47-57)."""
    step = limited_size / number_angles
    th = np.arange(0.0, limited_size + 1, step)
    angles = np.array([list(v) for v in itertools.product(th, th)])
    return np.append(angles, [list(custom_angle)], axis=0)


def sdf_datagen_config(**kw) -> DatagenConfig:
    """LCA/SDF datagen preset (sdftoray.py:16-45): focal 4000, source at
    [0,0,4000], 1000-unit sampling band, 2000 depth samples, 150x162 images,
    uncentered angle grid, per-image normalization."""
    base = dict(
        limited_size=25.0,
        number_angles=4.0,
        focal_length=4000.0,
        src_z_offset=0.0,
        sample_outside=1000.0,
        img_width=150,
        img_height=162,
        custom_angle=(112.5, 112.5),
        mode="sdf",
        angle_mode="sdf",
        per_image_normalize=True,
        sampling_strategy="segmentation",  # apply_frangi=False (sdftoray.py:24)
    )
    base.update(kw)
    return DatagenConfig(**base)


class GeneratedDataset(NamedTuple):
    """Everything the datagen produces, before the CSVs."""

    proj: dict  # the cttoproj column table (one row a view, JAX's columns in order)
    rays: RayDataset  # dense per-ray arrays on the device
    images: np.ndarray  # (V, H, W) jointly normalized DRRs
    weight_maps: np.ndarray  # (V, H, W) sampling weights
    angles: np.ndarray  # (V, 2) theta, phi


def max_grid_dim(volume: RegularGrid) -> float:
    """The largest |coordinate| of the volume's bounds, the scale of the
    translation shifts (cttoray.py:150-151)."""
    origin = volume.origin.cpu().numpy().astype(np.float64)
    spacing = volume.spacing.cpu().numpy().astype(np.float64)
    far = origin + spacing * (np.array(volume.values.shape) - 1)
    return float(np.abs(np.concatenate([origin, far])).max())


def pose_shifts(config: DatagenConfig, n_views: int, generator: torch.Generator,
                grid_dim: float) -> tuple[np.ndarray, np.ndarray]:
    """The random pose shifts, (n_views, 3) f32 each: a rotation (degrees,
    theta / phi / larm) uniform in +-max_shift_rotation and a translation
    uniform in +-max_shift_translation times ``grid_dim``; zero for the last
    (test) view and when both maxima are 0 (cttoray.py:194-206). The only
    draw of the pose shifts: the tests put JAX's in its place."""
    rot = np.zeros((n_views, 3), np.float32)
    tr = np.zeros((n_views, 3), np.float32)
    if config.max_shift_rotation > 0 or config.max_shift_translation > 0:
        u = torch.rand((2, n_views - 1, 3), generator=generator, dtype=torch.float32,
                       device=generator.device).cpu().numpy()
        r, t = np.float32(config.max_shift_rotation), np.float32(config.max_shift_translation)
        rot[:-1] = -r + u[0] * (2 * r)
        tr[:-1] = (-t + u[1] * (2 * t)) * np.float32(grid_dim)
    return rot, tr


def generate_dataset(
    volume: RegularGrid, config: DatagenConfig, generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> GeneratedDataset:
    """Run the datagen sweep (cttoray.py:189-267): per view rays and a DRR
    on the device, the weight map on the host. The stratified depths draw
    from ``generator``; without one, from a generator seeded with 0, so
    that a sweep is the same in every process, as the JAX package's
    default key PRNGKey(0) makes it. The pose shifts (pose_shifts) draw
    from the same generator after the depths."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    volume = volume.to(device)
    if config.angle_mode == "sdf":
        angles = sdf_angle_grid(config.limited_size, config.number_angles, config.custom_angle)
    else:
        angles = angle_grid(
            config.limited_size, config.number_angles, config.center_point, config.custom_angle
        )
    H, W = config.img_height, config.img_width
    if config.resize_to is not None and tuple(config.resize_to) != (H, W):
        # the reference's resize is only shape-consistent at identity scale
        # (sdftoray.py:40-45); there the JAX package's linear resize returns
        # its input up to one rounding, and the port skips it
        raise ValueError("resize_to must equal (img_height, img_width)")
    depth_base = linspace_depths(
        config.near_thresh, config.far_thresh, config.depth_samples_per_ray, device
    )
    depths = [stratify_depths(depth_base, generator) if config.stratified_depths
              else depth_base for _ in angles]
    shifts_rot, shifts_tr = pose_shifts(config, len(angles), generator, max_grid_dim(volume))
    imgs, wmaps, mats, unshifted_mats, all_origins, all_dirs = [], [], [], [], [], []
    for (theta, phi), depth_values, rot, tr in zip(angles, depths, shifts_rot, shifts_tr):
        # the angles in f32 arithmetic, as the JAX package adds its f32 draws
        origins, directions, c2w = get_ray_values(
            np.float32(theta) + rot[0], np.float32(phi) + rot[1],
            np.float32(config.larm) + rot[2], config.src_pt, W, H,
            config.focal_length, tuple(tr), device=device,
        )
        if rot.any() or tr.any():
            nom_origins, nom_dirs, unshifted_c2w = get_ray_values(
                float(theta), float(phi), config.larm, config.src_pt, W, H,
                config.focal_length, device=device,
            )
        else:
            nom_origins, nom_dirs, unshifted_c2w = origins, directions, c2w
        img_np = render_drr(volume, origins, directions, depth_values, config.mode).cpu().numpy()
        if config.per_image_normalize:  # sdftoray.py:125-127
            img_np = img_np - img_np.min()
            if img_np.max() > 0:
                img_np = img_np / img_np.max()
        # weight map (host, cold path) — cttoray.py:210-221
        img_to_transf = img_np.copy()
        if not config.binary:
            quantile = np.percentile(img_to_transf, 10)
            img_to_transf[img_to_transf > quantile] = 1.0
        if config.sampling_strategy == "random":
            wmap = np.ones_like(img_np)
        else:
            fa = 12.0 if config.binary else config.frangi_alpha
            wmap = get_weighted_img(
                img_to_transf, fa, config.frangi_beta, config.sampling_strategy
            )
        imgs.append(img_np)
        wmaps.append(np.asarray(wmap))
        mats.append(c2w.cpu().numpy())
        unshifted_mats.append(unshifted_c2w.cpu().numpy())
        ray_o, ray_d = ((nom_origins, nom_dirs) if config.rays_from_nominal
                        else (origins, directions))
        all_origins.append(ray_o.reshape(-1, 3))
        all_dirs.append(ray_d.reshape(-1, 3))

    images = np.stack(imgs)
    # joint normalization over all views (cttoray.py:265-267)
    images = images - images.min()
    mx = images.max()
    if mx > 0:
        images = images / mx
    weight_maps = np.stack(wmaps)

    V = len(angles)
    mats = np.stack(mats)
    proj = {
        "image_id": [f"{t}-{p}".replace(".", ",") for t, p in angles],
        "theta": angles[:, 0],
        "phi": angles[:, 1],
        "larm": [config.larm] * V,
        "theta_shift": [float(r[0]) for r in shifts_rot],
        "phi_shift": [float(r[1]) for r in shifts_rot],
        "larm_shift": [float(r[2]) for r in shifts_rot],
        "translation_x": [float(t[0]) for t in shifts_tr],
        "translation_y": [float(t[1]) for t in shifts_tr],
        "translation_z": [float(t[2]) for t in shifts_tr],
        "tform_cam2world": mats,
        "unshifted_tform_cam2world": np.stack(unshifted_mats),
        "image_data": images,
        "image_distance_data": weight_maps,
        "org_img_width": [W] * V,
        "org_img_height": [H] * V,
        "focal_length": [config.focal_length] * V,
        "near_thresh": [config.near_thresh] * V,
        "far_thresh": [config.far_thresh] * V,
        "depth_sample": [config.depth_samples_per_ray] * V,
        "grid_scaling_factor": [1.0] * V,
        "depth_values": np.broadcast_to(depth_base.cpu().numpy(), (V, depth_base.shape[0])),
        "src_pt_z": [float(config.src_pt[2])] * V,
    }
    ii = np.broadcast_to(np.arange(W)[None, :], (H, W)).reshape(-1)
    jj = np.broadcast_to(np.arange(H)[:, None], (H, W)).reshape(-1)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    rays = RayDataset(
        origins=torch.cat(all_origins).to(torch.float32).contiguous(),
        directions=torch.cat(all_dirs).to(torch.float32).contiguous(),
        pixel_values=dev(images.reshape(-1), torch.float32),
        weights=dev(weight_maps.reshape(-1), torch.float32),
        image_ids=torch.arange(V, device=device).repeat_interleave(H * W),
        x_positions=dev(np.tile(ii, V), torch.int64),
        y_positions=dev(np.tile(jj, V), torch.int64),
    )
    return GeneratedDataset(proj=proj, rays=rays, images=images, weight_maps=weight_maps,
                            angles=angles)


# ---------------------------------------------------------------------------
# CSV contract (the reference's schemas, sep=';')
# ---------------------------------------------------------------------------


def write_proj_csv(ds: GeneratedDataset, path: str) -> None:
    """df-{file_name}-{binary}-cttoproj.csv writer (cttoray.py:271-287)."""
    write_csv_table(ds.proj, path)


def write_rays_csv(ds: GeneratedDataset, path: str) -> None:
    """df-rays-{file_name}-... writer (cttoray.py:289-308)."""
    r = ds.rays
    ids = list(ds.proj["image_id"])
    o, d = r.origins.cpu().numpy(), r.directions.cpu().numpy()
    table = {
        "image_id": np.repeat(np.array(ids, dtype=object), r.num_rays // len(ids)),
        "pixel_value": r.pixel_values.cpu().numpy(),
        "distance_pixel_value": r.weights.cpu().numpy(),
        "x_position": r.x_positions.cpu().numpy(),
        "y_position": r.y_positions.cpu().numpy(),
        **{f"ray_origins_{c}": o[:, i] for i, c in enumerate("xyz")},
        **{f"ray_directions_{c}": d[:, i] for i, c in enumerate("xyz")},
    }
    write_csv_table(table, path)


def map_column_to_np(table: dict, column_name: str) -> np.ndarray:
    """Parse a list-valued CSV column (the reference stores images and
    matrices as stringified python lists; nerf_helpers.py:8-11 /
    proj_helpers.py:5-7)."""
    return np.array([literal_eval(v) if isinstance(v, str) else v
                     for v in table[column_name]])


def proj_images_from_csv(proj_csv: str) -> tuple[np.ndarray, np.ndarray]:
    """(images, weight_maps) arrays from a cttoproj CSV's image_data /
    image_distance_data columns."""
    table = read_csv_table(proj_csv)
    return map_column_to_np(table, "image_data"), map_column_to_np(table, "image_distance_data")


class LoadedData(NamedTuple):
    """What the reference's (missing) load_data returned, reconstructed from
    its uses at run_nerf_acc.py:82-124; the JAX package's field names, with
    column tables in place of its DataFrames."""

    proj_df: dict
    ray_df: dict | None  # None on the native path
    rays: RayDataset
    focal_length: float
    near_thresh: float
    far_thresh: float
    depth_samples: int
    src_pt_z: float
    num_views: int
    rays_per_view: int


def _plain_rays(table: dict) -> dict:
    """The per-ray table's arrays as the native loader returns them: f32 by
    way of the f64 parse, ids in order of first appearance."""
    ids = [str(v) for v in table["image_id"]]
    index = {v: i for i, v in enumerate(dict.fromkeys(ids))}

    def f32(c):
        return np.asarray(table[c], np.float64).astype(np.float32)

    return dict(
        origins=np.stack([f32(f"ray_origins_{c}") for c in "xyz"], -1),
        directions=np.stack([f32(f"ray_directions_{c}") for c in "xyz"], -1),
        pixel_values=f32("pixel_value"),
        weights=f32("distance_pixel_value"),
        x_positions=np.asarray(table["x_position"], np.int64),
        y_positions=np.asarray(table["y_position"], np.int64),
        image_ids=np.array([index[v] for v in ids], np.int64),
        num_views=len(index),
    )


def load_data(proj_csv: str, rays_csv: str, use_native: bool = True,
              device: str | torch.device = "cuda") -> LoadedData:
    """Read the two CSVs back, the rays onto ``device``.

    Reconstruction of the stripped ``load_data`` (run_nerf_acc.py:82): proj
    columns used at :120-124 (focal_length, near_thresh, far_thresh,
    depth_sample, src_pt_z); ray columns at :86-117. The per-ray table
    loads through the native parser, or with ``use_native=False`` through
    the ``csv`` module; both give the same arrays."""
    device = resolve_device(device)
    proj = read_csv_table(proj_csv)
    if use_native:
        from ..native import load_rays_csv

        ray_df, arrays = None, load_rays_csv(rays_csv)
    else:
        ray_df = read_csv_table(rays_csv)
        arrays = _plain_rays(ray_df)

    def dev(name, dtype):
        return torch.as_tensor(arrays[name], device=device).to(dtype)

    rays = RayDataset(
        origins=dev("origins", torch.float32),
        directions=dev("directions", torch.float32),
        pixel_values=dev("pixel_values", torch.float32),
        weights=dev("weights", torch.float32),
        image_ids=dev("image_ids", torch.int64),
        x_positions=dev("x_positions", torch.int64),
        y_positions=dev("y_positions", torch.int64),
    )
    num_views = arrays["num_views"]
    return LoadedData(
        proj_df=proj,
        ray_df=ray_df,
        rays=rays,
        focal_length=float(proj["focal_length"][0]),
        near_thresh=float(proj["near_thresh"][0]),
        far_thresh=float(proj["far_thresh"][0]),
        depth_samples=int(proj["depth_sample"][0]),
        src_pt_z=float(proj["src_pt_z"][0]),
        num_views=num_views,
        rays_per_view=rays.num_rays // num_views,
    )
