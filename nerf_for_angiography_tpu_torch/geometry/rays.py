"""Pinhole ray generation and depth sampling in torch (port of
``nerf_for_angiography_tpu/geometry/rays.py``; semantics of the reference's
phantomdata/helpers.py:156-190 and proj_helpers.py:9-32)."""

from __future__ import annotations

import torch

from .pose import source_matrix


def pixel_grid(img_width: int, img_height: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(ii, jj) pixel index grids of shape (H, W), 'xy' indexing
    (helpers.py:162-166)."""
    ii = torch.arange(img_width, dtype=torch.float32, device=device)[None, :].expand(
        img_height, img_width
    )
    jj = torch.arange(img_height, dtype=torch.float32, device=device)[:, None].expand(
        img_height, img_width
    )
    return ii, jj


def camera_directions(
    ii: torch.Tensor, jj: torch.Tensor, img_width: int, img_height: int, focal_length: float
) -> torch.Tensor:
    """Per-pixel camera-space direction ((i-W/2)/f, -(j-H/2)/f, -1),
    non-normalized (helpers.py:168-171)."""
    return torch.stack(
        [
            (ii - img_width / 2.0) / focal_length,
            -(jj - img_height / 2.0) / focal_length,
            -torch.ones_like(ii),
        ],
        dim=-1,
    )


def get_ray_values(
    theta_deg, phi_deg, larm_deg, src_pt, img_width: int, img_height: int,
    focal_length: float, translation=(0.0, 0.0, 0.0), device=None,
):
    """One view's rays: (origins (H,W,3), directions (H,W,3), cam2world
    (4,4)). Ref: helpers.py:156-175."""
    cam2world = source_matrix(src_pt, theta_deg, phi_deg, larm_deg, translation).to(device)
    ii, jj = pixel_grid(img_width, img_height, device)
    dirs_cam = camera_directions(ii, jj, img_width, img_height, focal_length)
    directions = torch.einsum("hwj,ij->hwi", dirs_cam, cam2world[:3, :3])
    origins = cam2world[:3, -1].expand(directions.shape)
    return origins, directions, cam2world


def linspace_depths(near: float, far: float, n: int, device=None) -> torch.Tensor:
    """Uniform depth values in [near, far] (helpers.py:178-179)."""
    t = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=device)
    return near * (1.0 - t) + far * t


def stratify_depths(z_vals: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """Jitter depths uniformly within their mid-point intervals
    (helpers.py:181-188)."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    t_rand = torch.rand(
        z_vals.shape, dtype=z_vals.dtype, device=z_vals.device, generator=generator
    )
    return lower + (upper - lower) * t_rand


def query_points(
    origins: torch.Tensor, directions: torch.Tensor, depth_values: torch.Tensor
) -> torch.Tensor:
    """o + d * z: (..., 3) rays, depths broadcastable to (..., n) ->
    (..., n, 3). Ref: proj_helpers.py:30. One rounding per coordinate
    (``addcmul``), as the JAX DRR's compiled o + d z, which XLA contracts
    into a fused multiply-add: at the SDF source distance (z ~ 4000) a
    second rounding moves the coordinate by up to 2^-11 and a pixel by
    ~1e-5."""
    return torch.addcmul(origins[..., None, :], directions[..., None, :],
                         depth_values[..., :, None])


def get_depth_values(near: float, far: float, n: int, generator: torch.Generator | None = None,
                     stratified: bool = True, device=None) -> torch.Tensor:
    """Depth samples for one ray bundle, stratified from ``generator``
    unless ``stratified`` is False (helpers.py:177-190). The JAX function
    raises without a key; here a stratified draw needs a generator too."""
    z = linspace_depths(near, far, n, device)
    if stratified:
        if generator is None:
            raise ValueError("stratified depth sampling requires a generator")
        z = stratify_depths(z, generator)
    return z


def segment_lengths(depth_values: torch.Tensor, infinite_last: bool = True) -> torch.Tensor:
    """Per-sample segment lengths; the last is 1e10 like the reference's
    (helpers.py:200-201 / nerf_helpers.py:60-61), or with ``infinite_last``
    False a copy of the one before it."""
    d = depth_values[..., 1:] - depth_values[..., :-1]
    last = torch.full_like(depth_values[..., :1], 1e10) if infinite_last else d[..., -1:]
    return torch.cat([d, last], dim=-1)
