"""Volume assets: a VTK file -> an attenuation grid, and the datagen's VTK
side artifacts (port of ``nerf_for_angiography_tpu/data/volumes.py``).

Reproduces phantomdata/helpers.py:72-154 (get_interpolator_from_vol_sdf /
get_interpolator_from_vol_ct / get_interpolator_from_grid) without pyvista:
the volume is read with the legacy-VTK reader, passed through the transfer
function and held as a ``RegularGrid`` that ``ops/interpolation.trilinear``
samples. A STRUCTURED_GRID whose points arrive in any order is put back on
its lattice by a nearest-neighbour pass (scipy's ``cKDTree``, as the JAX
package and the reference do; imported where it is used).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.interpolation import RegularGrid, trilinear
from ..utils.vtk import VtkGrid, read_vtk, write_structured_grid
from .transfer import rev_sigmoid, transfer_func_ct

# points a trilinear call of the ground-truth export takes at a time
_GT_CHUNK = 1 << 21


def _axes_from_grid(grid: VtkGrid) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-axis coordinates of a rectilinear lattice (both reference volumes
    are; the reference's KDTree re-gridding at helpers.py:143-148 only
    reorders scattered point lists)."""
    if grid.kind == "structured_points":
        nx, ny, nz = grid.dimensions
        ox, oy, oz = grid.origin
        sx, sy, sz = grid.spacing
        return ox + sx * np.arange(nx), oy + sy * np.arange(ny), oz + sz * np.arange(nz)
    pts = np.round(grid.points, 3)  # helpers.py:137 rounding
    return np.unique(pts[:, 0]), np.unique(pts[:, 1]), np.unique(pts[:, 2])


def _scalars_3d(grid: VtkGrid, name: str = "scalars") -> np.ndarray:
    if name not in grid.point_data:
        name = next(iter(grid.point_data))
    if grid.kind == "structured_points":
        return grid.scalars_3d(name)
    # STRUCTURED_GRID: re-grid the scalars onto the rectilinear lattice by
    # nearest neighbour, the reference's KDTree pass (helpers.py:143-148)
    from scipy.spatial import cKDTree

    pts = np.round(grid.points, 3)
    xs, ys, zs = (np.unique(pts[:, i]) for i in range(3))
    scalars = np.asarray(grid.point_data[name], np.float64)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    _, idx = cKDTree(pts).query(np.stack([gx, gy, gz], -1).reshape(-1, 3))
    return scalars[idx].reshape(len(xs), len(ys), len(zs))


def _spacing(xs, ys, zs) -> np.ndarray:
    return np.array([(a[-1] - a[0]) / max(len(a) - 1, 1) for a in (xs, ys, zs)])


def load_ct_volume(path: str, translation=(0.0, 0.0, 0.0), binary: bool = False,
                   extra_translation=(-30.0, 10.0, -30.0), device=None) -> RegularGrid:
    """CT volume -> attenuation grid (get_interpolator_from_vol_ct,
    helpers.py:102-128): the grid centred, the manual LCA-centring
    translation (cttoray.py:55) and ``translation`` applied to its origin,
    transfer_func_ct applied, fill value = min."""
    g = read_vtk(path)
    xs, ys, zs = _axes_from_grid(g)
    vals = transfer_func_ct(_scalars_3d(g), binary=binary).numpy()
    center = np.array([(xs[0] + xs[-1]) / 2, (ys[0] + ys[-1]) / 2, (zs[0] + zs[-1]) / 2])
    shift = -center + np.asarray(extra_translation) + np.asarray(translation)
    origin = np.array([xs[0], ys[0], zs[0]]) + shift
    return RegularGrid.create(vals, origin, _spacing(xs, ys, zs),
                              fill_value=float(vals.min()), device=device)


def load_sdf_volume(path: str, scale: float = 1.0, c1: float = 2.0, device=None) -> RegularGrid:
    """SDF volume -> attenuation grid via rev_sigmoid (helpers.py:72-100):
    the lattice scaled, centred on the density-weighted centre of mass,
    1 / (1 + exp(c1 sdf))."""
    g = read_vtk(path)
    xs, ys, zs = (a * scale for a in _axes_from_grid(g))
    vals = rev_sigmoid(_scalars_3d(g).astype(np.float32), c1=c1).numpy()
    # density-weighted centre of mass (pyvista's center_of_mass)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    w = np.maximum(vals, 0)
    tot = w.sum()
    com = (np.array([(gx * w).sum(), (gy * w).sum(), (gz * w).sum()]) / tot
           if tot > 0 else np.zeros(3))
    origin = np.array([xs[0], ys[0], zs[0]]) - com
    return RegularGrid.create(vals, origin, _spacing(xs, ys, zs),
                              fill_value=float(vals.min()), device=device)


def export_transferfunc_vtk(volume: RegularGrid, path: str, binary: bool = False) -> None:
    """transferfunc.vtk (helpers.py:122-126): the volume's own lattice with
    its transfer-applied scalars, rotated -90 degrees about x ("so it
    matches prediction volume"), as a STRUCTURED_GRID; VTK binary mode for
    the binary transfer variant (helpers.py:125-126)."""
    vals = volume.values.cpu().numpy().astype(np.float32)
    nx, ny, nz = vals.shape
    origin = volume.origin.cpu().numpy().astype(np.float64)
    spacing = volume.spacing.cpu().numpy().astype(np.float64)
    gx, gy, gz = np.meshgrid(*(origin[i] + spacing[i] * np.arange(n)
                               for i, n in enumerate((nx, ny, nz))), indexing="ij")
    # Rx(-90): (x, y, z) -> (x, z, -y)  (pyvista rotate_x(-90))
    vtk_pts = np.stack([a.transpose(2, 1, 0).ravel() for a in (gx, gz, -gy)], -1)
    write_structured_grid(path, vtk_pts, (nx, ny, nz),
                          {"scalars": vals.transpose(2, 1, 0).ravel()}, binary=binary)


@torch.no_grad()
def export_ground_truth_vtk(volume: RegularGrid, path: str, extent: float = 75.0,
                           res: int = 200) -> None:
    """ground-truth.vtk (cttoray.py:134-148): the attenuation volume queried
    on a res^3 lattice over [-extent, extent]^3 (trilinear on the volume's
    device), written as a STRUCTURED_GRID point cloud."""
    t = np.linspace(-extent, extent, res, dtype=np.float32)
    gx, gy, gz = np.meshgrid(t, t, t)  # the reference's meshgrid default ('xy')
    pts = torch.from_numpy(np.stack([gx, gy, gz], -1).reshape(-1, 3))
    dev = volume.values.device
    vals = np.concatenate([trilinear(volume, pts[s:s + _GT_CHUNK].to(dev)).cpu().numpy()
                           for s in range(0, pts.shape[0], _GT_CHUNK)]).reshape(gx.shape)
    vtk_pts = np.stack([a.transpose(2, 1, 0).ravel() for a in (gx, gy, gz)], -1)
    write_structured_grid(path, vtk_pts, (res, res, res),
                          {"scalars": vals.transpose(2, 1, 0).ravel()},
                          binary=True)  # 8M points; ASCII is ~100x slower
