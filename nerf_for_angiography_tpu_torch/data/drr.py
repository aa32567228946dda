"""DRR (digitally reconstructed radiograph) rendering in torch (port of
``nerf_for_angiography_tpu/data/drr.py``; the reference's ray_tracing,
phantomdata/helpers.py:192-224)."""

from __future__ import annotations

import torch

from ..geometry import get_ray_values, query_points
from ..ops.interpolation import RegularGrid, trilinear


def render_drr(
    volume: RegularGrid, origins: torch.Tensor, directions: torch.Tensor,
    depth_values: torch.Tensor, mode: str = "ct",
) -> torch.Tensor:
    """One DRR: (H, W, 3) rays and (n_samples,) depths -> (H, W) image.

    'ct': weights exp(-interp * dist * |dir|) with a 1e10 last segment
    (helpers.py:208-211); 'sdf': exp(-interp) (helpers.py:213)."""
    pts = query_points(origins, directions, depth_values)
    interp = trilinear(volume, pts)
    if mode == "ct":
        dists = torch.cat(
            [depth_values[1:] - depth_values[:-1], torch.full_like(depth_values[:1], 1e10)]
        )
        norm = torch.linalg.norm(directions, dim=-1)
        tau = interp * dists * norm[..., None]
    else:
        tau = interp
    return torch.exp(-tau.sum(dim=-1))


def render_view(
    volume: RegularGrid, theta: float, phi: float, larm: float, src_pt, img_width: int,
    img_height: int, focal_length: float, depth_values: torch.Tensor,
    translation=(0.0, 0.0, 0.0), mode: str = "ct",
):
    """Rays + DRR for one C-arm view: (image, origins, directions,
    cam2world). Ref flow: cttoray.py:200-208."""
    origins, directions, c2w = get_ray_values(
        theta, phi, larm, src_pt, img_width, img_height, focal_length, translation,
        device=volume.values.device,
    )
    img = render_drr(volume, origins, directions, depth_values, mode)
    return img, origins, directions, c2w
