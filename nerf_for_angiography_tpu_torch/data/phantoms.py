"""Analytic phantoms (numpy; port of ``nerf_for_angiography_tpu/data/
phantoms.py``): a constant-density sphere with its closed-form line
integral, a capsule coronary-tree phantom with vessel-like DRRs, and the
tree's signed distance through the SDF transfer (the LCA stand-in)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.interpolation import RegularGrid


def _grid_coords(res: int, extent: float) -> np.ndarray:
    t = np.linspace(-extent, extent, res, dtype=np.float32)
    gx, gy, gz = np.meshgrid(t, t, t, indexing="ij")
    return np.stack([gx, gy, gz], -1)


def make_sphere_volume(
    res: int = 64, extent: float = 75.0, radius: float = 30.0, mu: float = 0.02, device=None
) -> RegularGrid:
    """Constant-attenuation sphere (optical depth 2*radius*mu through the
    center)."""
    pts = _grid_coords(res, extent)
    r = np.linalg.norm(pts, axis=-1)
    vals = np.where(r <= radius, mu, 0.0).astype(np.float32)
    spacing = 2 * extent / (res - 1)
    return RegularGrid.create(
        vals, origin=(-extent,) * 3, spacing=(spacing,) * 3, fill_value=0.0, device=device
    )


def _capsule_distance(pts: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ab = b - a
    t = np.clip(((pts - a) @ ab) / (ab @ ab), 0.0, 1.0)
    proj = a + t[..., None] * ab
    return np.linalg.norm(pts - proj, axis=-1)


# a stylized left-coronary-tree: (start, end, radius) in mm, centered near 0
_VESSEL_SEGMENTS = [
    ((0.0, 45.0, 0.0), (0.0, 10.0, 2.0), 4.0),  # left main
    ((0.0, 10.0, 2.0), (-25.0, -30.0, 8.0), 3.2),  # LAD
    ((0.0, 10.0, 2.0), (28.0, -20.0, -6.0), 3.0),  # LCx
    ((-12.0, -10.0, 5.0), (-35.0, -18.0, 20.0), 2.0),  # diagonal
    ((14.0, -5.0, -2.0), (30.0, -38.0, 6.0), 1.8),  # marginal
    ((-25.0, -30.0, 8.0), (-30.0, -55.0, 2.0), 2.2),  # distal LAD
]


def make_vessel_volume(
    res: int = 96, extent: float = 75.0, mu: float = 0.03, background_mu: float = 0.0,
    device=None,
) -> RegularGrid:
    """Capsule-tree phantom with vessel-like DRR projections."""
    pts = _grid_coords(res, extent).reshape(-1, 3)
    vals = np.full(pts.shape[0], background_mu, np.float32)
    for a, b, radius in _VESSEL_SEGMENTS:
        d = _capsule_distance(pts, np.asarray(a, np.float32), np.asarray(b, np.float32))
        # soft edge one voxel wide for band-limited projections
        soft = np.clip((radius - d) / (2 * extent / res) + 0.5, 0.0, 1.0)
        vals = np.maximum(vals, (mu * soft).astype(np.float32))
    spacing = 2 * extent / (res - 1)
    return RegularGrid.create(
        vals.reshape(res, res, res), origin=(-extent,) * 3, spacing=(spacing,) * 3,
        fill_value=0.0, device=device,
    )


def make_lca_sdf_volume(
    res: int = 96, extent: float = 60.0, c1: float = 2.0, device=None
) -> RegularGrid:
    """Analytic LCA stand-in for the reference's SDF-LCA.vtk asset: the
    signed distance to the capsule coronary tree through the same
    ``rev_sigmoid`` transfer the reference applies to the real file
    (helpers.py:72-100), for the SDF datagen (``sdf_datagen_config``,
    ``render_drr(mode='sdf')``)."""
    from .transfer import rev_sigmoid

    pts = _grid_coords(res, extent).reshape(-1, 3)
    sdf = np.full(pts.shape[0], np.inf, np.float32)
    for a, b, radius in _VESSEL_SEGMENTS:
        d = _capsule_distance(pts, np.asarray(a, np.float32), np.asarray(b, np.float32))
        sdf = np.minimum(sdf, d - radius)
    vals = rev_sigmoid(torch.from_numpy(sdf), c1=c1).numpy()
    spacing = 2 * extent / (res - 1)
    return RegularGrid.create(
        vals.reshape(res, res, res), origin=(-extent,) * 3, spacing=(spacing,) * 3,
        fill_value=0.0, device=device,
    )


def sphere_line_integral(
    origin: np.ndarray, direction: np.ndarray, radius: float, mu: float
) -> float:
    """Closed-form Beer-Lambert pixel for the sphere phantom:
    exp(-mu * chord_length)."""
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    b = o @ d
    c = o @ o - radius**2
    disc = b * b - c
    if disc <= 0:
        return 1.0
    chord = 2.0 * np.sqrt(disc)
    return float(np.exp(-mu * chord))
