"""Occupancy grid and dense-lattice marching in torch (port of the dense
subset of ``nerf_for_angiography_tpu/ops/occupancy.py``).

nerfacc semantics as the JAX package reproduces them: a binary grid over an
axis-aligned box, EMA-updated from density samples every n steps
(``occs = max(occs * decay, sigma)``, ``binary = occs > min(mean(occs),
occ_thre)``), and grid-pruned marching on a fixed (n_rays, n_samples) lattice
with a {0, 1} mask. The compacted marches (window / hybrid / hybrid2k) come
with slice 2.

The JAX module bit-packs the grid for its TPU gather; here the mask is read
from the bool grid directly, which gives the same occupancy bits.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch


class OccupancyGrid(NamedTuple):
    """occs (res,res,res) f32 EMA density; binary (res,res,res) bool;
    aabb (6,) f32 [min xyz, max xyz]; feasible: optional persistent carve
    mask (carve_feasible), None = all feasible."""

    occs: torch.Tensor
    binary: torch.Tensor
    aabb: torch.Tensor
    feasible: torch.Tensor | None = None

    @property
    def resolution(self) -> int:
        return self.occs.shape[0]


def create_grid(aabb, resolution: int = 128, feasible: torch.Tensor | None = None,
                device=None) -> OccupancyGrid:
    """Fresh grid, everything occupied (nerfacc's conservative start); with
    ``feasible``, provably-empty cells start and stay pruned."""
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=device)
    shape = (resolution,) * 3
    binary = torch.ones(shape, dtype=torch.bool, device=aabb.device)
    if feasible is not None:
        binary = binary & feasible
    return OccupancyGrid(
        occs=torch.zeros(shape, dtype=torch.float32, device=aabb.device),
        binary=binary, aabb=aabb, feasible=feasible,
    )


def _binarize(occs: torch.Tensor, thresh: torch.Tensor, feasible: torch.Tensor | None):
    binary = occs > thresh
    return binary if feasible is None else binary & feasible


def _centers(lo, hi, xi, idx):
    xs = lo[0] + xi * (hi[0] - lo[0])
    ys = lo[1] + idx * (hi[1] - lo[1])
    zs = lo[2] + idx * (hi[2] - lo[2])
    gx, gy, gz = torch.meshgrid(xs, ys, zs, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def cell_centers(grid: OccupancyGrid) -> torch.Tensor:
    """(res^3, 3) world-space coordinates of all cell centers."""
    res = grid.resolution
    idx = (torch.arange(res, dtype=torch.float32, device=grid.aabb.device) + 0.5) / res
    return _centers(grid.aabb[:3], grid.aabb[3:], idx, idx)


def _slab_centers(grid: OccupancyGrid, start: int, slab: int) -> torch.Tensor:
    """(slab*res^2, 3) cell centers of x-rows [start, start+slab)."""
    res = grid.resolution
    dev = grid.aabb.device
    idx = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5) / res
    xi = (torch.arange(slab, dtype=torch.float32, device=dev) + float(start) + 0.5) / res
    return _centers(grid.aabb[:3], grid.aabb[3:], xi, idx)


def _jitter(grid: OccupancyGrid, pts: torch.Tensor, generator: torch.Generator | None):
    if generator is None:
        return pts
    cell_size = (grid.aabb[3:] - grid.aabb[:3]) / grid.resolution
    u = torch.rand(pts.shape, generator=generator, device=pts.device)
    return pts + (u - 0.5) * cell_size


def _apply(g: OccupancyGrid, occs: torch.Tensor, thre: float) -> OccupancyGrid:
    thresh = torch.clamp(occs.mean(), max=thre)
    return OccupancyGrid(
        occs=occs, binary=_binarize(occs, thresh, g.feasible), aabb=g.aabb, feasible=g.feasible
    )


@torch.no_grad()
def update_grid_pair(
    grid: OccupancyGrid, vessel_grid: OccupancyGrid,
    sigma_fn: Callable[[torch.Tensor], torch.Tensor], occ_thre: float, vessel_thre: float,
    ema_decay: float = 0.95, generator: torch.Generator | None = None,
) -> tuple[OccupancyGrid, OccupancyGrid]:
    """EMA-update the scene and vessel grids from ONE shared sigma pass over
    every cell center (optionally jittered inside the cell)."""
    res = grid.resolution
    pts = _jitter(grid, cell_centers(grid), generator)
    sigma = sigma_fn(pts).reshape(res, res, res)

    def apply(g, thre):
        return _apply(g, torch.maximum(g.occs * ema_decay, sigma), thre)

    return apply(grid, occ_thre), apply(vessel_grid, vessel_thre)


@torch.no_grad()
def update_grid_pair_slab(
    grid: OccupancyGrid, vessel_grid: OccupancyGrid,
    sigma_fn: Callable[[torch.Tensor], torch.Tensor], occ_thre: float, vessel_thre: float,
    update_idx: int, n_slabs: int = 4, ema_decay: float = 0.95,
    generator: torch.Generator | None = None,
) -> tuple[OccupancyGrid, OccupancyGrid]:
    """Partial EMA update: every cell decays, one rotating 1/n_slabs x-slab
    gets fresh sigma maxed in; thresholds use the full-grid mean."""
    res = grid.resolution
    if res % n_slabs:
        raise ValueError(f"resolution {res} not divisible by {n_slabs} slabs")
    slab = res // n_slabs
    start = (update_idx % n_slabs) * slab
    pts = _jitter(grid, _slab_centers(grid, start, slab), generator)
    sigma = sigma_fn(pts).reshape(slab, res, res)

    def apply(g, thre):
        occs = g.occs * ema_decay
        occs[start : start + slab] = torch.maximum(occs[start : start + slab], sigma)
        return _apply(g, occs, thre)

    return apply(grid, occ_thre), apply(vessel_grid, vessel_thre)


def every_n_step_pair(
    grid: OccupancyGrid, vessel_grid: OccupancyGrid, step: int,
    sigma_fn: Callable[[torch.Tensor], torch.Tensor], occ_thre: float, vessel_thre: float,
    n: int = 16, ema_decay: float = 0.95, generator: torch.Generator | None = None,
    slabs: int = 1, warmup_steps: int = 256,
) -> tuple[OccupancyGrid, OccupancyGrid]:
    """Every-n gate over the pair update, on the host-side step counter:
    dense updates during ``warmup_steps``, rotating slabs after it when
    ``slabs > 1`` divides the resolution."""
    if step % n:
        return grid, vessel_grid
    if slabs <= 1 or grid.resolution % slabs or step < warmup_steps:
        return update_grid_pair(
            grid, vessel_grid, sigma_fn, occ_thre, vessel_thre, ema_decay, generator
        )
    return update_grid_pair_slab(
        grid, vessel_grid, sigma_fn, occ_thre, vessel_thre, update_idx=step // n,
        n_slabs=slabs, ema_decay=ema_decay, generator=generator,
    )


def query_occ(grid: OccupancyGrid, points: torch.Tensor) -> torch.Tensor:
    """Occupancy lookup at world points (..., 3); False outside the AABB."""
    res = grid.resolution
    lo, hi = grid.aabb[:3], grid.aabb[3:]
    inside = ((points >= lo) & (points <= hi)).all(dim=-1)
    norm = (points - lo) / (hi - lo)
    idx = torch.clamp((norm * res).to(torch.int64), 0, res - 1)
    flat = (idx[..., 0] * res + idx[..., 1]) * res + idx[..., 2]
    return grid.binary.reshape(-1)[flat] & inside


def _dilate3(x: torch.Tensor) -> torch.Tensor:
    """3x3x3 binary dilation (window 3, stride 1, same padding)."""
    for axis in range(3):
        n = x.shape[axis]
        pad = [0, 0] * 3
        pad[2 * (2 - axis)] = 1
        pad[2 * (2 - axis) + 1] = 1
        xp = torch.nn.functional.pad(x.to(torch.uint8), pad).to(torch.bool)
        x = xp.narrow(axis, 0, n) | xp.narrow(axis, 1, n) | xp.narrow(axis, 2, n)
    return x


@torch.no_grad()
def carve_feasible(
    origins: torch.Tensor, directions: torch.Tensor, pixel_values: torch.Tensor,
    aabb, resolution: int, near: float, far: float, thresh: float = 0.995,
    samples_per_cell: float = 2.0, chunk: int = 8192,
) -> torch.Tensor:
    """Space-carving feasibility mask from the training rays: every cell an
    unattenuated (pixel >= thresh) ray traverses is provably empty; the
    carved set is eroded by one cell. Returns bool (res,res,res), True =
    feasible."""
    dev = origins.device
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=dev)
    res = int(resolution)
    lo, hi = aabb[:3], aabb[3:]
    extent = float((hi - lo).max())
    cell = extent / res
    n_s = int(np.ceil((far - near) / (cell / samples_per_cell)))
    n_s = max(8, min(n_s, 4 * res * int(np.ceil(samples_per_cell))))
    ts = near + (torch.arange(n_s, dtype=torch.float32, device=dev) + 0.5) * (
        (far - near) / n_s
    )
    n_cells = res * res * res
    carved = torch.zeros((n_cells + 1,), dtype=torch.bool, device=dev)
    white = pixel_values >= thresh
    for s in range(0, origins.shape[0], chunk):
        co, cd, cw = origins[s : s + chunk], directions[s : s + chunk], white[s : s + chunk]
        pos = co[:, None, :] + cd[:, None, :] * ts[None, :, None]
        inside = ((pos >= lo) & (pos <= hi)).all(dim=-1)
        idx = torch.clamp(((pos - lo) / (hi - lo) * res).to(torch.int64), 0, res - 1)
        flat = (idx[..., 0] * res + idx[..., 1]) * res + idx[..., 2]
        flat = torch.where(cw[:, None] & inside, flat, torch.full_like(flat, n_cells))
        carved[flat.reshape(-1)] = True
    carved = carved[:n_cells].reshape(res, res, res)
    return _dilate3(~carved)


def safe_occ_stride(
    stride: int, n_samples: int, near: float, far: float, aabb_extent: float, resolution: int
) -> int:
    """Largest stride <= ``stride`` whose probe spacing stays below the cell
    size (the superset-mask guarantee of strided probing)."""
    if stride <= 1:
        return max(1, stride)
    step = (far - near) / n_samples
    cell = aabb_extent / resolution
    safe = stride
    while safe > 1 and safe * step >= cell:
        safe -= 1
    if safe != stride:
        warnings.warn(
            f"occ_stride={stride} breaks the superset-mask guarantee "
            f"(probe spacing {stride * step:.4g} >= cell size {cell:.4g}); "
            f"falling back to occ_stride={safe}",
            stacklevel=2,
        )
    return safe


def ray_aabb_intersect(
    aabb: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Slab-method ray/AABB intersection -> (t_enter, t_exit); misses give
    t_enter > t_exit."""
    lo, hi = aabb[:3], aabb[3:]
    d = torch.where(directions.abs() < 1e-10, torch.full_like(directions, 1e-10), directions)
    inv = 1.0 / d
    t0 = (lo - origins) * inv
    t1 = (hi - origins) * inv
    t_enter = torch.minimum(t0, t1).amax(dim=-1)
    t_exit = torch.maximum(t0, t1).amin(dim=-1)
    return t_enter, t_exit


class MarchedRays(NamedTuple):
    """Fixed-width sample lattice: t_starts/t_ends (n_rays, n_samples),
    positions (n_rays, n_samples, 3) segment midpoints, mask {0,1} f32."""

    t_starts: torch.Tensor
    t_ends: torch.Tensor
    positions: torch.Tensor
    mask: torch.Tensor


def march_rays(
    grid: OccupancyGrid, origins: torch.Tensor, directions: torch.Tensor, n_samples: int,
    near: float, far: float, compact_k: int | None = None, occ_stride: int = 1,
) -> MarchedRays:
    """Uniform-step grid-pruned marching with fixed output shapes
    (nerfacc.ray_marching stepping, occupancy by lookup, AABB clipping by
    slab intersection). With ``occ_stride > 1`` the grid is probed every
    stride-th sample and a sample is active if either bracketing probe
    hits."""
    if compact_k is not None and compact_k < n_samples:
        raise NotImplementedError("compacted marching (compact_k) arrives with slice 2")
    step = (far - near) / n_samples
    i = torch.arange(n_samples, dtype=torch.float32, device=origins.device)
    t_starts = (near + i * step).expand(origins.shape[:-1] + (n_samples,))
    t_ends = t_starts + step
    t_mid = (t_starts + t_ends) / 2.0
    positions = origins[..., None, :] + directions[..., None, :] * t_mid[..., None]

    t_enter, t_exit = ray_aabb_intersect(grid.aabb, origins, directions)
    in_box = (t_mid >= t_enter[..., None]) & (t_mid <= t_exit[..., None])
    if occ_stride > 1:
        occ_p = query_occ(grid, positions[..., ::occ_stride, :])
        left = occ_p.repeat_interleave(occ_stride, dim=-1)[..., :n_samples]
        occ_next = torch.cat([occ_p[..., 1:], occ_p[..., -1:]], dim=-1)
        right = occ_next.repeat_interleave(occ_stride, dim=-1)[..., :n_samples]
        occupied = left | right
    else:
        occupied = query_occ(grid, positions)
    mask = (in_box & occupied).to(torch.float32)
    return MarchedRays(t_starts=t_starts, t_ends=t_ends, positions=positions, mask=mask)


def prune_mask(
    sigma: torch.Tensor, dists: torch.Tensor, mask: torch.Tensor,
    alpha_thre: float = 0.0, early_stop_eps: float = 0.0,
) -> torch.Tensor:
    """nerfacc's alpha-threshold and transmittance early-stop refinement of
    a marching mask, on detached sigma (nerf_helpers_acc.py:10-31)."""
    s = sigma.detach()
    keep = mask
    if alpha_thre > 0.0:
        provisional_alpha = 1.0 - torch.exp(-s * dists)
        keep = keep * (provisional_alpha >= alpha_thre).to(torch.float32)
    if early_stop_eps > 0.0:
        tau = s * dists * keep
        trans = torch.exp(-(torch.cumsum(tau, dim=-1) - tau))
        keep = keep * (trans >= early_stop_eps).to(torch.float32)
    return keep
