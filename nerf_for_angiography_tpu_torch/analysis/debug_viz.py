"""Debug visualization helpers (port of
``nerf_for_angiography_tpu/analysis/debug_viz.py``).

Equivalents of the reference's matplotlib sanity-check utilities
(phantomdata/helpers.py:249-281: visualize_volume, visualize_query_points):
a volume's bounding-box corners and a few corner / centre rays, to check
camera geometry against the volume. Headless (Agg) and savefig-based;
matplotlib is imported when a plot is drawn.
"""

from __future__ import annotations

import numpy as np
import torch

from .plots import pyplot


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def visualize_volume(grid_bounds, out_path: str, grid_scaling_factor: float = 1.0):
    """Scatter the 8 corners of a volume's bounds (helpers.py:249-265)."""
    plt = pyplot()
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    xb, yb, zb = grid_bounds[0:2], grid_bounds[2:4], grid_bounds[4:6]
    for x in xb:
        for y in yb:
            for z in zb:
                ax.scatter(x / grid_scaling_factor, y / grid_scaling_factor,
                           z / grid_scaling_factor, color="red")
                ax.scatter(x, y, z, color="grey")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def visualize_query_points(origins, directions, depth_values, img_width: int, img_height: int,
                           out_path: str, grid_bounds=None):
    """Plot corner / centre / edge rays as 3D segments (helpers.py:267-281)
    to check the camera geometry; optionally over the volume bounds."""
    plt = pyplot()
    origins, directions, depth_values = _np(origins), _np(directions), _np(depth_values)

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    for x in (0, img_width // 2 - 1, img_width - 1):
        for y in (0, img_height // 2 - 1, img_height - 1):
            o, d = origins[y, x], directions[y, x]
            seg = np.array([o + d * depth_values[0], o + d * depth_values[-1]]).T
            ax.plot(seg[0], seg[1], seg[2], c="grey")
    if grid_bounds is not None:
        xb, yb, zb = grid_bounds[0:2], grid_bounds[2:4], grid_bounds[4:6]
        for x in xb:
            for y in yb:
                for z in zb:
                    ax.scatter(x, y, z, color="red", s=12)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
