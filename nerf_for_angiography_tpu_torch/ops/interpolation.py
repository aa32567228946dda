"""Trilinear interpolation on regular grids in torch (port of
``nerf_for_angiography_tpu/ops/interpolation.py``; scipy
RegularGridInterpolator(method='linear', bounds_error=False) semantics)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RegularGrid(NamedTuple):
    """A regular scalar grid: values (nx, ny, nz) f32, origin (3,) at
    values[0,0,0], spacing (3,), fill_value outside the grid."""

    values: torch.Tensor
    origin: torch.Tensor
    spacing: torch.Tensor
    fill_value: torch.Tensor

    @classmethod
    def create(cls, values, origin, spacing, fill_value=None, device=None) -> "RegularGrid":
        values = torch.as_tensor(values, dtype=torch.float32, device=device)
        if fill_value is None:
            fill_value = values.min()
        return cls(
            values=values,
            origin=torch.as_tensor(origin, dtype=torch.float32, device=values.device),
            spacing=torch.as_tensor(spacing, dtype=torch.float32, device=values.device),
            fill_value=torch.as_tensor(fill_value, dtype=torch.float32, device=values.device),
        )

    def to(self, device) -> "RegularGrid":
        return RegularGrid(*(t.to(device) for t in self))


def trilinear(grid: RegularGrid, points: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of ``grid`` at world ``points`` (..., 3)."""
    dims = grid.values.shape
    shape = torch.tensor(dims, dtype=torch.float32, device=points.device)
    u = (points - grid.origin) / grid.spacing
    inside = ((u >= 0.0) & (u <= shape - 1.0)).all(dim=-1)
    u = torch.minimum(torch.clamp(u, min=0.0), shape - 1.0)
    maxi = torch.tensor([d - 1 for d in dims], dtype=torch.int64, device=points.device)
    i0 = torch.minimum(torch.floor(u).to(torch.int64), maxi - (maxi > 0).to(torch.int64))
    i0 = torch.clamp(i0, min=0)
    i1 = torch.minimum(i0 + 1, maxi)
    f = u - i0.to(torch.float32)

    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    fx, fy, fz = f.unbind(-1)
    v = grid.values
    c00 = v[x0, y0, z0] * (1 - fx) + v[x1, y0, z0] * fx
    c10 = v[x0, y1, z0] * (1 - fx) + v[x1, y1, z0] * fx
    c01 = v[x0, y0, z1] * (1 - fx) + v[x1, y0, z1] * fx
    c11 = v[x0, y1, z1] * (1 - fx) + v[x1, y1, z1] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    out = c0 * (1 - fz) + c1 * fz
    return torch.where(inside, out, grid.fill_value)
