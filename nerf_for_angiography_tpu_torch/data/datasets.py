"""Dataset synthesis (port of ``generate_dataset`` from
``nerf_for_angiography_tpu/data/datasets.py``; the reference's
phantomdata/cttoray.py flow).

It covers the CT sweep (cttoray.py) and the SDF/LCA sweep (sdftoray.py:
``angle_mode='sdf'``, ``mode='sdf'`` DRRs, ``per_image_normalize``, and
``resize_to`` at identity) without pose shifts, and returns rays, images,
weight maps and angles. The ``proj`` table, the CSV writers and
``load_data`` arrive with the datagen/CLI slice.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import get_ray_values, linspace_depths, stratify_depths
from ..ops.interpolation import RegularGrid
from ..ops.sampling import RayDataset
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
    max_shift_rotation: float = 0.0
    max_shift_translation: float = 0.0
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
    rays: RayDataset  # dense per-ray arrays on the device
    images: np.ndarray  # (V, H, W) jointly normalized DRRs
    weight_maps: np.ndarray  # (V, H, W) sampling weights
    angles: np.ndarray  # (V, 2) theta, phi


def _check_ported(config: DatagenConfig) -> None:
    if config.max_shift_rotation > 0 or config.max_shift_translation > 0:
        raise NotImplementedError("pose-shift datagen arrives with the pose-refinement slice")


def generate_dataset(
    volume: RegularGrid, config: DatagenConfig, generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> GeneratedDataset:
    """Run the datagen sweep (cttoray.py:189-267): per view rays and a DRR
    on the device, the weight map on the host. The stratified depths draw
    from ``generator``; without one, from a generator seeded with 0, so
    that a sweep is the same in every process, as the JAX package's
    default key PRNGKey(0) makes it."""
    _check_ported(config)
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
    imgs, wmaps, all_origins, all_dirs = [], [], [], []
    for theta, phi in angles:
        if config.stratified_depths:
            depth_values = stratify_depths(depth_base, generator)
        else:
            depth_values = depth_base
        origins, directions, _ = get_ray_values(
            float(theta), float(phi), config.larm, config.src_pt, W, H,
            config.focal_length, device=device,
        )
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
        all_origins.append(origins.reshape(-1, 3))
        all_dirs.append(directions.reshape(-1, 3))

    images = np.stack(imgs)
    # joint normalization over all views (cttoray.py:265-267)
    images = images - images.min()
    mx = images.max()
    if mx > 0:
        images = images / mx
    weight_maps = np.stack(wmaps)

    V = len(angles)
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
    return GeneratedDataset(rays=rays, images=images, weight_maps=weight_maps, angles=angles)
