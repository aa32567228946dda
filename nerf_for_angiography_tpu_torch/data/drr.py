"""DRR (digitally reconstructed radiograph) rendering in torch (port of
``nerf_for_angiography_tpu/data/drr.py``; the reference's ray_tracing,
phantomdata/helpers.py:192-224). A sweep of views is embarrassingly
parallel and can be sharded over the ranks of a mesh
(``render_views_sharded``)."""

from __future__ import annotations

import torch

from ..geometry import get_ray_values, query_points
from ..ops.interpolation import RegularGrid, trilinear
from ..parallel import collectives
from ..parallel.mesh import mesh_coords


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


def render_views_sharded(
    volume: RegularGrid, thetas, phis, src_pt, img_width: int, img_height: int,
    focal_length: float, depth_values: torch.Tensor, mode: str = "ct", mesh=None,
) -> torch.Tensor:
    """(B, H, W) DRRs of the views (thetas[i], phis[i]) at larm 0, rendered
    one view at a time. With ``mesh`` (a 1-D ``DeviceMesh``) the angle list
    is padded with (0, 0) views to a multiple of the mesh's size, each rank
    renders its contiguous slice, the volume being replicated, and every
    rank gets all B (all-gathered): each view's image is the one an
    unsharded call renders."""
    dev = volume.values.device

    def render(ts, ps) -> torch.Tensor:
        imgs = []
        for t, p in zip(ts, ps):
            o, d, _ = get_ray_values(float(t), float(p), 0.0, src_pt, img_width, img_height,
                                     focal_length, device=dev)
            imgs.append(render_drr(volume, o, d, depth_values, mode))
        return (torch.stack(imgs) if imgs
                else torch.zeros((0, img_height, img_width), dtype=torch.float32, device=dev))

    thetas, phis = [float(t) for t in thetas], [float(p) for p in phis]
    if mesh is None:
        return render(thetas, phis)
    rank, world = mesh_coords(mesh)
    n = len(thetas)
    per = -(-n // world)
    pad = [0.0] * (per * world - n)
    mine = slice(rank * per, (rank + 1) * per)
    return collectives.all_gather_cat(render((thetas + pad)[mine], (phis + pad)[mine]), mesh)[:n]
