"""Occupancy grid, dense-lattice and compacted marching in torch (port of
``nerf_for_angiography_tpu/ops/occupancy.py``).

nerfacc semantics as the JAX package reproduces them: a binary grid over an
axis-aligned box, EMA-updated from density samples every n steps
(``occs = max(occs * decay, sigma)``, ``binary = occs > min(mean(occs),
occ_thre)``), and grid-pruned marching on a fixed (n_rays, n_samples) lattice
with a {0, 1} mask. The compacted marches keep fewer samples per ray:
'window' (k consecutive lattice samples from a conservative window found on
a dilated coarse grid), first-k-active compaction of the lattice
(``march_rays(compact_k=...)``), 'hybrid' (first-k inside a w_cap window),
and the two-bucket 'hybrid2' / 'hybrid2k' (rays sorted by window span, the
narrow ``split`` share at a smaller window, and for hybrid2k a smaller k).

The JAX module bit-packs the grid and the dilated coarse grid for its TPU
gather; here both are read as bool tensors, which gives the same occupancy
bits. Like the JAX grid, the port's grid caches its dilated coarse table and
rebuilds it wherever ``binary`` changes.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..parallel.mesh import shard_bounds
from .kernels import march as mk
from .kernels.first_k import first_k_active


class OccupancyGrid(NamedTuple):
    """occs (res,res,res) f32 EMA density; binary (res,res,res) bool;
    aabb (6,) f32 [min xyz, max xyz]; feasible: optional persistent carve
    mask (carve_feasible), None = all feasible; coarse: the cached dilated
    coarse table of ``binary`` at ``coarse_factor`` (coarse_dilated_grid),
    None = built on the fly by the marches that read it."""

    occs: torch.Tensor
    binary: torch.Tensor
    aabb: torch.Tensor
    feasible: torch.Tensor | None = None
    coarse: torch.Tensor | None = None

    @property
    def resolution(self) -> int:
        return self.occs.shape[0]

    @property
    def coarse_factor(self) -> int:
        """The factor the coarse table is (and marches are) built at."""
        return max(1, self.resolution // 32)


def with_coarse(grid: OccupancyGrid) -> OccupancyGrid:
    """Rebuild the cached dilated coarse table from grid.binary."""
    coarse, _ = coarse_dilated_grid(grid.binary, grid.coarse_factor)
    return grid._replace(coarse=coarse)


def create_grid(aabb, resolution: int = 128, feasible: torch.Tensor | None = None,
                device=None) -> OccupancyGrid:
    """Fresh grid, everything occupied (nerfacc's conservative start); with
    ``feasible``, provably-empty cells start and stay pruned."""
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=device)
    shape = (resolution,) * 3
    binary = torch.ones(shape, dtype=torch.bool, device=aabb.device)
    if feasible is not None:
        binary = binary & feasible
    return with_coarse(OccupancyGrid(
        occs=torch.zeros(shape, dtype=torch.float32, device=aabb.device),
        binary=binary, aabb=aabb, feasible=feasible,
    ))


def grid_from_numpy(binary, aabb, occs=None, feasible=None, device=None) -> OccupancyGrid:
    """A grid from host arrays (bool binary/feasible, f32 occs; occs default
    0), with its coarse table built."""

    def t(a, dtype):
        # a copy: the grid's tensors are updated in place
        return None if a is None else torch.tensor(np.asarray(a), dtype=dtype, device=device)

    b = t(binary, torch.bool)
    return with_coarse(OccupancyGrid(
        occs=t(occs, torch.float32) if occs is not None else torch.zeros(
            b.shape, dtype=torch.float32, device=b.device),
        binary=b, aabb=t(aabb, torch.float32), feasible=t(feasible, torch.bool),
    ))


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


def _write_pair(grids, occs_new, thres) -> tuple[OccupancyGrid, OccupancyGrid]:
    """Rebinarize each grid from its new occs, then write occs, binary and
    the coarse table into the grid's own tensors (``copy_``), so a captured
    CUDA graph's addresses stay valid. Every new value is formed before the
    first write, so a grid passed as both members updates once."""
    new = []
    for g, occs, thre in zip(grids, occs_new, thres):
        binary = _binarize(occs, torch.clamp(occs.mean(), max=thre), g.feasible)
        coarse = None if g.coarse is None else coarse_dilated_grid(binary, g.coarse_factor)[0]
        new.append((occs, binary, coarse))
    for g, (occs, binary, coarse) in zip(grids, new):
        g.occs.copy_(occs)
        g.binary.copy_(binary)
        if coarse is not None:
            g.coarse.copy_(coarse)
    return grids[0], grids[1]


@torch.no_grad()
def update_grid_pair(
    grid: OccupancyGrid, vessel_grid: OccupancyGrid,
    sigma_fn: Callable[[torch.Tensor], torch.Tensor], occ_thre: float, vessel_thre: float,
    ema_decay: float = 0.95, generator: torch.Generator | None = None,
) -> tuple[OccupancyGrid, OccupancyGrid]:
    """EMA-update the scene and vessel grids from ONE shared sigma pass over
    every cell center (optionally jittered inside the cell), in place."""
    res = grid.resolution
    pts = _jitter(grid, cell_centers(grid), generator)
    sigma = sigma_fn(pts).reshape(res, res, res)
    grids = (grid, vessel_grid)
    return _write_pair(grids, [torch.maximum(g.occs * ema_decay, sigma) for g in grids],
                       (occ_thre, vessel_thre))


@torch.no_grad()
def update_grid_pair_slab(
    grid: OccupancyGrid, vessel_grid: OccupancyGrid,
    sigma_fn: Callable[[torch.Tensor], torch.Tensor], occ_thre: float, vessel_thre: float,
    update_idx: int, n_slabs: int = 4, ema_decay: float = 0.95,
    generator: torch.Generator | None = None,
) -> tuple[OccupancyGrid, OccupancyGrid]:
    """Partial EMA update, in place: every cell decays, one rotating
    1/n_slabs x-slab gets fresh sigma maxed in; thresholds use the full-grid
    mean."""
    res = grid.resolution
    if res % n_slabs:
        raise ValueError(f"resolution {res} not divisible by {n_slabs} slabs")
    slab = res // n_slabs
    start = (update_idx % n_slabs) * slab
    pts = _jitter(grid, _slab_centers(grid, start, slab), generator)
    sigma = sigma_fn(pts).reshape(slab, res, res)

    def decayed(g):
        occs = g.occs * ema_decay
        occs[start : start + slab] = torch.maximum(occs[start : start + slab], sigma)
        return occs

    grids = (grid, vessel_grid)
    return _write_pair(grids, [decayed(g) for g in grids], (occ_thre, vessel_thre))


def grid_update_kind(
    step: int, resolution: int, n: int = 16, slabs: int = 1, warmup_steps: int = 256
) -> int | str | None:
    """What the every-n gate does at ``step``: None (no update), 'dense'
    (every cell; the warm-up steps, or no slabs) or the slab index it
    refreshes. A CUDA graph of a step is captured for one of these kinds."""
    if step % n:
        return None
    if slabs <= 1 or resolution % slabs or step < warmup_steps:
        return "dense"
    return (step // n) % slabs


def every_n_step_pair(
    grid: OccupancyGrid, vessel_grid: OccupancyGrid, step: int,
    sigma_fn: Callable[[torch.Tensor], torch.Tensor], occ_thre: float, vessel_thre: float,
    n: int = 16, ema_decay: float = 0.95, generator: torch.Generator | None = None,
    slabs: int = 1, warmup_steps: int = 256,
) -> tuple[OccupancyGrid, OccupancyGrid]:
    """Every-n gate over the pair update, on the host-side step counter
    (grid_update_kind): dense updates during ``warmup_steps``, rotating slabs
    after it when ``slabs > 1`` divides the resolution."""
    kind = grid_update_kind(step, grid.resolution, n, slabs, warmup_steps)
    if kind is None:
        return grid, vessel_grid
    if kind == "dense":
        return update_grid_pair(
            grid, vessel_grid, sigma_fn, occ_thre, vessel_thre, ema_decay, generator
        )
    return update_grid_pair_slab(
        grid, vessel_grid, sigma_fn, occ_thre, vessel_thre, update_idx=step // n,
        n_slabs=slabs, ema_decay=ema_decay, generator=generator,
    )


def _query_bits(binary: torch.Tensor, aabb: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Lookup of a (res,res,res) bool table over ``aabb`` at world points
    (..., 3); False outside the AABB."""
    res = binary.shape[0]
    lo, hi = aabb[:3], aabb[3:]
    inside = ((points >= lo) & (points <= hi)).all(dim=-1)
    norm = (points - lo) / (hi - lo)
    idx = torch.clamp((norm * res).to(torch.int64), 0, res - 1)
    flat = (idx[..., 0] * res + idx[..., 1]) * res + idx[..., 2]
    return binary.reshape(-1)[flat] & inside


def query_occ(grid: OccupancyGrid, points: torch.Tensor) -> torch.Tensor:
    """Occupancy lookup at world points (..., 3); False outside the AABB."""
    return _query_bits(grid.binary, grid.aabb, points)


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


def coarse_dilated_grid(binary: torch.Tensor, factor: int) -> tuple[torch.Tensor, int]:
    """Max-pool a (res,res,res) bool grid by ``factor`` and dilate by one
    coarse cell (26-neighborhood) -> (bool (cres,cres,cres) table, cres).

    The dilation buys the window-march superset guarantee: any fine-occupied
    point lies inside an occupied coarse cell, and every point within one
    coarse cell of it (per axis) lands in a dilated-occupied cell, so a
    probe within a cell size of an occupied point always hits."""
    res = binary.shape[0]
    cres = res // factor
    c = binary.reshape(cres, factor, cres, factor, cres, factor)
    c = c.any(dim=5).any(dim=3).any(dim=1)
    return _dilate3(c), cres


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
    positions (n_rays, n_samples, 3) segment midpoints, mask {0,1} f32.

    The compacted marches attach truncation-pressure stats (None on the
    dense lattice): ``active_count`` (n_rays,) int32, the candidate samples
    active BEFORE compaction, and ``edge_active`` (n_rays,) bool, whether
    the candidate window's far edge is active (the active region may
    continue past it). train.py::march_pressure reduces them per step."""

    t_starts: torch.Tensor
    t_ends: torch.Tensor
    positions: torch.Tensor
    mask: torch.Tensor
    active_count: torch.Tensor | None = None
    edge_active: torch.Tensor | None = None


def takes_kernels(device, shard: tuple[int, int] | None = None) -> bool:
    """The dispatch of a compacted march (every mode): the march kernels
    (ops/kernels/march.py) for rays on the card and an unsharded march, the
    op chain below, their plain version, otherwise. A chain march counts
    in ``march_chain``, a kernel march in ``march_fused``; the dense
    lattice counts in neither."""
    return torch.device(device).type == "cuda" and shard is None


def _origin_grad(positions: torch.Tensor, origins: torch.Tensor) -> torch.Tensor:
    """The kernels' positions carry no autograd. Where the origins require
    grad (pose refinement), ``positions + (o - o.detach())``: the same
    values, and the backward of the chain's ``o[..., None, :] + d * t``,
    the broadcast sum over the samples."""
    if not (origins.requires_grad and torch.is_grad_enabled()):
        return positions
    return positions + (origins - origins.detach())[..., None, :]


def _kernel_rays(out: list, origins: torch.Tensor) -> MarchedRays:
    """MarchedRays of a kernel's outputs, its rows on ``origins``."""
    ts, te, pos, mask, count, edge = out
    return MarchedRays(ts, te, _origin_grad(pos, origins), mask, count, edge)


def _occupied(grid: OccupancyGrid, positions: torch.Tensor, occ_stride: int) -> torch.Tensor:
    """Occupancy of every sample of (..., n, 3) positions; with
    ``occ_stride > 1`` the grid is probed every stride-th sample and a
    sample is occupied if either bracketing probe hits."""
    if occ_stride <= 1:
        return query_occ(grid, positions)
    n = positions.shape[-2]
    occ_p = query_occ(grid, positions[..., ::occ_stride, :])
    left = occ_p.repeat_interleave(occ_stride, dim=-1)[..., :n]
    occ_next = torch.cat([occ_p[..., 1:], occ_p[..., -1:]], dim=-1)
    right = occ_next.repeat_interleave(occ_stride, dim=-1)[..., :n]
    return left | right


def _lattice_at(origins, directions, idx: torch.Tensor, near: float, step: float):
    """(t_starts, t_ends, positions) of the lattice samples ``idx`` (R, k)
    int32: t is affine in the sample index, so nothing is gathered."""
    t_starts = near + idx.to(torch.float32) * step
    t_ends = t_starts + step
    t_mid = t_starts + step / 2.0
    positions = origins[..., None, :] + directions[..., None, :] * t_mid[..., None]
    return t_starts, t_ends, positions


def march_rays(
    grid: OccupancyGrid, origins: torch.Tensor, directions: torch.Tensor, n_samples: int,
    near: float, far: float, compact_k: int | None = None, occ_stride: int = 1,
    fka: str = "xla",
) -> MarchedRays:
    """Uniform-step grid-pruned marching with fixed output shapes
    (nerfacc.ray_marching stepping, occupancy by lookup, AABB clipping by
    slab intersection). With ``occ_stride > 1`` the grid is probed every
    stride-th sample and a sample is active if either bracketing probe
    hits.

    ``compact_k``: emit only the first k active samples per ray
    (_first_k_active); t and positions of the kept samples are recomputed
    from their lattice indices."""
    compacting = compact_k is not None and compact_k < n_samples
    if compacting:
        _check_fka(fka)
        if takes_kernels(origins.device):
            return _kernel_rays(mk.march_fine_cuda(
                origins, directions, grid.aabb, grid.binary, n_samples, near, far, mk.LATTICE,
                n_samples, compact_k, occ_stride=occ_stride), origins)
        mk.count_chain()
    step = (far - near) / n_samples
    i = torch.arange(n_samples, dtype=torch.float32, device=origins.device)
    t_starts = (near + i * step).expand(origins.shape[:-1] + (n_samples,))
    t_ends = t_starts + step
    t_mid = (t_starts + t_ends) / 2.0
    positions = origins[..., None, :] + directions[..., None, :] * t_mid[..., None]

    t_enter, t_exit = ray_aabb_intersect(grid.aabb, origins, directions)
    in_box = (t_mid >= t_enter[..., None]) & (t_mid <= t_exit[..., None])
    mask = (in_box & _occupied(grid, positions, occ_stride)).to(torch.float32)
    if not compacting:
        return MarchedRays(t_starts=t_starts, t_ends=t_ends, positions=positions, mask=mask)

    sel, mask_k = _first_k_active(mask, compact_k, fka)
    t_starts_k, t_ends_k, positions_k = _lattice_at(origins, directions, sel, near, step)
    return MarchedRays(
        t_starts=t_starts_k, t_ends=t_ends_k, positions=positions_k, mask=mask_k,
        # the candidates are the whole lattice: active_count > k is exact
        # truncation, and there is no window edge
        active_count=mask.sum(dim=-1, dtype=torch.int32),
        edge_active=torch.zeros(mask.shape[:-1], dtype=torch.bool, device=mask.device),
    )


def _check_fka(fka: str) -> None:
    if fka not in ("xla", "pallas"):
        raise ValueError(f"unknown first-k implementation fka={fka!r} (use 'xla' or 'pallas')")


def _first_k_active(mask: torch.Tensor, k: int, fka: str = "xla"):
    """(sel, mask_k): indices and activity of the first k active samples of
    each row (ops/kernels/first_k.py). The JAX package's two
    implementations, 'xla' (a broadcast compare and count) and 'pallas'
    (the TPU kernel), compute the same function; in the port both names
    mean it: the CUDA kernel on the card, its plain version on the CPU."""
    _check_fka(fka)
    return first_k_active(mask, k)


def window_probe_stride(
    n_samples: int, near: float, far: float, aabb_extent: float, coarse_res: int
) -> int:
    """Largest probe stride keeping the window-march superset guarantee:
    probe spacing stride*step stays below 2x the coarse cell size."""
    step = (far - near) / n_samples
    cell = aabb_extent / coarse_res
    return max(1, min(n_samples, int(2.0 * cell / step) - 1))


def _window_plan(grid: OccupancyGrid, n_samples: int, near: float, far: float,
                 coarse_factor: int | None, aabb_extent: float | None):
    """How coarse_window probes: (table, stride, slack, n_probe), the
    dilated coarse table (the grid's cached one at its own factor) and the
    probe stride, the window's tightening per side and the probe count."""
    res = grid.resolution
    if coarse_factor is None:
        coarse_factor = grid.coarse_factor
    if res % coarse_factor:
        raise ValueError(f"grid resolution {res} not divisible by {coarse_factor}")
    step = (far - near) / n_samples
    if grid.coarse is not None and coarse_factor == grid.coarse_factor:
        table, cres = grid.coarse, res // coarse_factor
    else:
        table, cres = coarse_dilated_grid(grid.binary, coarse_factor)
    if aabb_extent is None:
        aabb_extent = float(grid.aabb[3] - grid.aabb[0])
    stride = window_probe_stride(n_samples, near, far, aabb_extent, cres)
    # a MISS at a probe proves no occupied fine cell within one coarse cell
    # of it, i.e. no active sample within cell/step samples: the window
    # tightens by `slack` per side
    slack = max(int((aabb_extent / cres) / step) - 1, 0)
    return table, stride, slack, -(-n_samples // stride)


def coarse_window(
    grid: OccupancyGrid, origins: torch.Tensor, directions: torch.Tensor, n_samples: int,
    near: float, far: float, coarse_factor: int | None = None,
    aabb_extent: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-ray conservative active sample-index window from the dilated
    coarse grid -> (start_idx, end_idx, any_hit), each (R,), int32/int32/bool.

    Every active fine sample of the exact march lies in [start, end] (the
    dilation + probe-stride guarantee of coarse_dilated_grid /
    window_probe_stride). Pass ``aabb_extent`` on a hot path: without it the
    extent is read from ``grid.aabb`` (a device-to-host copy)."""
    table, stride, slack, n_probe = _window_plan(
        grid, n_samples, near, far, coarse_factor, aabb_extent)
    step = (far - near) / n_samples
    dev = origins.device
    probe_idx = torch.clamp(
        torch.arange(n_probe, dtype=torch.int32, device=dev) * stride, max=n_samples - 1
    )
    probe_t = near + (probe_idx.to(torch.float32) + 0.5) * step
    probe_pos = origins[..., None, :] + directions[..., None, :] * probe_t[:, None]
    hit = _query_bits(table, grid.aabb, probe_pos)  # (R, n_probe)

    any_hit = hit.any(dim=-1)
    hit_i = hit.to(torch.uint8)
    # argmax returns the first maximal index; rows without a hit give 0
    first_p = torch.argmax(hit_i, dim=-1).to(torch.int32)
    last_p = (n_probe - 1) - torch.argmax(torch.flip(hit_i, dims=(-1,)), dim=-1).to(torch.int32)
    start_idx = torch.clamp((first_p - 1) * stride + slack, min=0)
    # no probe after the last one: no miss evidence, keep the lattice end
    end_raw = (last_p + 1) * stride + (stride - 1) - slack
    end_idx = torch.where(
        last_p >= n_probe - 1,
        torch.full_like(end_raw, n_samples - 1),
        torch.clamp(end_raw, max=n_samples - 1),
    )
    return start_idx, end_idx, any_hit


def march_rays_window(
    grid: OccupancyGrid, origins: torch.Tensor, directions: torch.Tensor, n_samples: int,
    near: float, far: float, k: int, coarse_factor: int | None = None,
    aabb_extent: float | None = None,
) -> MarchedRays:
    """Contiguous-window march: k consecutive lattice samples from each
    ray's conservative coarse-window start. Every sample the exact march
    keeps inside the window is kept (same lattice); gap samples between
    occupied segments are kept too and composited with their own density.
    Rays whose active span exceeds k lose their farthest samples; rays with
    no probe hit are fully masked."""
    if takes_kernels(origins.device):
        plan = _window_plan(grid, n_samples, near, far, coarse_factor, aabb_extent)
        return _kernel_rays(mk.march_fine_cuda(
            origins, directions, grid.aabb, grid.binary, n_samples, near, far, mk.WINDOW, k, k,
            coarse=plan), origins)
    mk.count_chain()
    start_idx, end_idx, any_hit = coarse_window(
        grid, origins, directions, n_samples, near, far,
        coarse_factor=coarse_factor, aabb_extent=aabb_extent,
    )
    step = (far - near) / n_samples
    w = torch.clamp(start_idx, 0, max(n_samples - k, 0))  # (R,)
    sel = w[..., None] + torch.arange(k, dtype=torch.int32, device=origins.device)
    t_starts, t_ends, positions = _lattice_at(origins, directions, sel, near, step)
    t_mid = t_starts + step / 2.0

    t_enter, t_exit = ray_aabb_intersect(grid.aabb, origins, directions)
    in_box = (t_mid >= t_enter[..., None]) & (t_mid <= t_exit[..., None])
    mask = (in_box & (sel <= end_idx[..., None]) & any_hit[..., None]).to(torch.float32)
    return MarchedRays(
        t_starts=t_starts, t_ends=t_ends, positions=positions, mask=mask,
        # the window keeps every sample it covers: the only truncation is
        # the coarse window reaching past the k-window's end
        active_count=mask.sum(dim=-1, dtype=torch.int32),
        edge_active=any_hit & (end_idx > w + (k - 1)),
    )


def hybrid_w_cap(k: int, n_samples: int) -> int:
    """Default candidate-window width of the hybrid march."""
    return min(n_samples, max(k + 32, 160))


def march_rays_hybrid(
    grid: OccupancyGrid, origins: torch.Tensor, directions: torch.Tensor, n_samples: int,
    near: float, far: float, k: int, w_cap: int | None = None, occ_stride: int = 1,
    coarse_factor: int | None = None, aabb_extent: float | None = None, fka: str = "xla",
) -> MarchedRays:
    """Two-level march: the coarse window locates each ray's active region,
    then the exact strided fine query and first-k compaction run over the
    w_cap lattice samples starting there. Masking equals march_rays inside
    the window; actives beyond start + w_cap are truncated."""
    if w_cap is None:
        w_cap = hybrid_w_cap(k, n_samples)
    w_cap = min(w_cap, n_samples)
    if takes_kernels(origins.device):
        _check_fka(fka)
        plan = _window_plan(grid, n_samples, near, far, coarse_factor, aabb_extent)
        return _kernel_rays(mk.march_fine_cuda(
            origins, directions, grid.aabb, grid.binary, n_samples, near, far, mk.HYBRID, w_cap, k,
            occ_stride=occ_stride, coarse=plan), origins)
    mk.count_chain()
    start_idx, _, any_hit = coarse_window(
        grid, origins, directions, n_samples, near, far,
        coarse_factor=coarse_factor, aabb_extent=aabb_extent,
    )
    return _hybrid_fine(
        grid, origins, directions, start_idx, any_hit,
        n_samples, near, far, k, w_cap, occ_stride, fka,
    )


def hybrid_window_mask(
    grid: OccupancyGrid, origins: torch.Tensor, directions: torch.Tensor,
    start_idx: torch.Tensor, any_hit: torch.Tensor, n_samples: int, near: float, far: float,
    w_cap: int, occ_stride: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The candidates of the hybrid march: (w, mask), the window start per
    ray, clamped so the w_cap window stays on the lattice, and the exact
    strided fine mask (R, w_cap) over the window."""
    step = (far - near) / n_samples
    w = torch.clamp(start_idx, 0, max(n_samples - w_cap, 0))  # (R,)
    abs_idx = w[..., None] + torch.arange(w_cap, dtype=torch.int32, device=origins.device)
    t_mid = near + (abs_idx.to(torch.float32) + 0.5) * step
    positions = origins[..., None, :] + directions[..., None, :] * t_mid[..., None]

    t_enter, t_exit = ray_aabb_intersect(grid.aabb, origins, directions)
    in_box = (t_mid >= t_enter[..., None]) & (t_mid <= t_exit[..., None])
    occupied = _occupied(grid, positions, occ_stride)
    return w, (in_box & occupied & any_hit[..., None]).to(torch.float32)


def _hybrid_fine(
    grid: OccupancyGrid, origins: torch.Tensor, directions: torch.Tensor,
    start_idx: torch.Tensor, any_hit: torch.Tensor, n_samples: int, near: float, far: float,
    k: int, w_cap: int, occ_stride: int, fka: str = "xla",
) -> MarchedRays:
    """Level 2 of the hybrid march: first-k compaction of the fine mask over
    each ray's w_cap window (hybrid_window_mask)."""
    step = (far - near) / n_samples
    w, mask = hybrid_window_mask(
        grid, origins, directions, start_idx, any_hit, n_samples, near, far, w_cap, occ_stride
    )
    sel, mask_k = _first_k_active(mask, k, fka)  # (R, k), relative to w
    t_starts_k, t_ends_k, positions_k = _lattice_at(
        origins, directions, w[..., None] + sel, near, step
    )
    return MarchedRays(
        t_starts=t_starts_k, t_ends=t_ends_k, positions=positions_k, mask=mask_k,
        # actives within the window (> k = exact k-truncation); an active
        # LAST window sample of a window that stops short of the lattice end
        # means the active region may continue past w_cap
        active_count=mask.sum(dim=-1, dtype=torch.int32),
        edge_active=(mask[..., -1] > 0) & (w + w_cap < n_samples),
    )


def _span_sorted(grid, origins, directions, n_samples, near, far, coarse_factor, aabb_extent):
    """The coarse window and the stable sort of the rays by its span (misses
    first): (perm, start_idx, any_hit, origins, directions), the last four
    in sorted order."""
    start_idx, end_idx, any_hit = coarse_window(
        grid, origins, directions, n_samples, near, far,
        coarse_factor=coarse_factor, aabb_extent=aabb_extent,
    )
    span = torch.where(any_hit, end_idx - start_idx + 1, torch.zeros_like(end_idx))
    perm = torch.argsort(span, stable=True)
    return (
        perm,
        start_idx.index_select(0, perm), any_hit.index_select(0, perm),
        origins.index_select(0, perm), directions.index_select(0, perm),
    )


def share_march(march, grid, origins, directions, shard, **kw):
    """(``march(grid, o, d, **kw)`` of this rank's contiguous share (o, d)
    of the rays, their rows in the batch); ``shard`` = (rank, world). For
    the marches that work ray by ray."""
    a, b = shard_bounds(origins.shape[0], *shard)
    if a == b:
        raise ValueError(f"{origins.shape[0]} rays leave rank {shard[0]} of {shard[1]} none")
    rows = torch.arange(a, b, device=origins.device)
    return march(grid, origins[a:b], directions[a:b], **kw), rows


def _bucket_shares(n_rays: int, cut: int, shard) -> tuple[slice, slice]:
    """This rank's contiguous slices of the span-sorted lo bucket [0, cut)
    and hi bucket [cut, n_rays)."""
    la, lb = shard_bounds(cut, *shard)
    ha, hb = shard_bounds(n_rays - cut, *shard)
    if la == lb or ha == hb:
        raise ValueError(f"a bucket of {n_rays} rays split at {cut} leaves rank {shard[0]} of "
                         f"{shard[1]} no ray")
    return slice(la, lb), slice(cut + ha, cut + hb)


def march_rays_hybrid2(
    grid: OccupancyGrid, origins: torch.Tensor, directions: torch.Tensor, n_samples: int,
    near: float, far: float, k: int, w_lo: int, w_cap: int | None = None,
    split: float = 0.75, occ_stride: int = 1, coarse_factor: int | None = None,
    aabb_extent: float | None = None, fka: str = "xla", shard: tuple[int, int] | None = None,
):
    """Two-bucket hybrid march: rays sorted by coarse-window span, the
    narrow ``split`` share marched at w_lo, the rest at w_cap, both at k.
    Rows come back in the INPUT ray order. Degenerate configurations (too
    few rays, w_lo >= w_cap) fall back to march_rays_hybrid.

    With ``shard=(rank, world)`` the sort and the cut run on the whole
    batch, as one process would run them, and only this rank's contiguous
    slice of each bucket is marched: returns (march, rows), the march's
    rows being the batch rows ``rows``, in increasing order."""
    n_rays = origins.shape[0]
    if w_cap is None:
        w_cap = hybrid_w_cap(k, n_samples)
    w_cap = min(w_cap, n_samples)
    w_lo = min(max(w_lo, 16), w_cap)
    cut = int(n_rays * split)
    if n_rays < 2 or cut < 1 or cut >= n_rays or w_lo >= w_cap:
        kw = dict(n_samples=n_samples, near=near, far=far, k=k, w_cap=w_cap,
                  occ_stride=occ_stride, coarse_factor=coarse_factor, aabb_extent=aabb_extent,
                  fka=fka)
        if shard is not None:
            return share_march(march_rays_hybrid, grid, origins, directions, shard, **kw)
        return march_rays_hybrid(grid, origins, directions, **kw)
    if takes_kernels(origins.device, shard):
        _check_fka(fka)
        plan = _window_plan(grid, n_samples, near, far, coarse_factor, aabb_extent)
        out, _, _, _ = mk.march_buckets_cuda(
            origins, directions, grid.aabb, grid.binary, n_samples, near, far, cut, (w_lo, k),
            (w_cap, k), occ_stride=occ_stride, coarse=plan, scatter=True)
        return _kernel_rays(out, origins)
    mk.count_chain()
    perm, st_s, ah_s, o_s, d_s = _span_sorted(
        grid, origins, directions, n_samples, near, far, coarse_factor, aabb_extent
    )
    lo, hi = (slice(0, cut), slice(cut, n_rays)) if shard is None else _bucket_shares(
        n_rays, cut, shard)
    m_lo = _hybrid_fine(grid, o_s[lo], d_s[lo], st_s[lo], ah_s[lo],
                        n_samples, near, far, k, w_lo, occ_stride, fka)
    m_hi = _hybrid_fine(grid, o_s[hi], d_s[hi], st_s[hi], ah_s[hi],
                        n_samples, near, far, k, w_cap, occ_stride, fka)
    rows = perm if shard is None else torch.cat([perm[lo], perm[hi]])
    inv = torch.argsort(rows)

    def cat(a, b):
        return torch.cat([a, b], dim=0).index_select(0, inv)

    m = MarchedRays(*(cat(a, b) for a, b in zip(m_lo, m_hi)))
    return m if shard is None else (m, rows.index_select(0, inv))


class BucketedRays(NamedTuple):
    """Two-bucket march output (march_rays_hybrid2k): the span-sorted batch
    split into a narrow lo bucket at (w_lo, k_lo) and a wide hi bucket at
    (w_cap, k). The buckets keep different sample counts per ray, so they
    are not concatenated back into one MarchedRays. ``inv`` maps
    cat([lo, hi]) ROW order back to the input ray order (apply it to
    per-ray quantities only); ``perm`` is the span sort (cat row j is input
    ray perm[j])."""

    lo: MarchedRays  # (R_lo, k_lo)
    hi: MarchedRays  # (R_hi, k)
    inv: torch.Tensor  # (R,) int64
    perm: torch.Tensor | None = None


def march_rays_hybrid2k(
    grid: OccupancyGrid, origins: torch.Tensor, directions: torch.Tensor, n_samples: int,
    near: float, far: float, k: int, k_lo: int, w_lo: int, w_cap: int | None = None,
    split: float = 0.75, occ_stride: int = 1, coarse_factor: int | None = None,
    aabb_extent: float | None = None, fka: str = "xla", shard: tuple[int, int] | None = None,
):
    """Two-bucket hybrid march with a k for each bucket: the lo bucket emits
    k_lo samples per ray, the hi bucket k. Each bucket runs the exact
    _hybrid_fine march at its own (window, k). Degenerate configurations
    (k_lo >= k, w_lo >= w_cap, too few rays) fall back to the single-k
    marches, so callers branch on the return type.

    With ``shard=(rank, world)`` the sort and the cut run on the whole
    batch and only this rank's contiguous slice of each bucket is marched:
    returns (march, rows), ``rows`` the batch rows of the march's rows (lo
    slice first; a BucketedRays then takes its rays in that order, its
    ``perm`` and ``inv`` the identity)."""
    n_rays = origins.shape[0]
    if w_cap is None:
        w_cap = hybrid_w_cap(k, n_samples)
    w_cap = min(w_cap, n_samples)
    w_lo = min(max(w_lo, 16), w_cap)
    k_lo = min(max(k_lo, 8), k)
    cut = int(n_rays * split)
    if k_lo >= k:
        return march_rays_hybrid2(
            grid, origins, directions, n_samples, near, far, k,
            w_lo=w_lo, w_cap=w_cap, split=split, occ_stride=occ_stride,
            coarse_factor=coarse_factor, aabb_extent=aabb_extent, fka=fka, shard=shard,
        )
    if n_rays < 2 or cut < 1 or cut >= n_rays or w_lo >= w_cap:
        kw = dict(n_samples=n_samples, near=near, far=far, k=k, w_cap=w_cap,
                  occ_stride=occ_stride, coarse_factor=coarse_factor, aabb_extent=aabb_extent,
                  fka=fka)
        if shard is not None:
            return share_march(march_rays_hybrid, grid, origins, directions, shard, **kw)
        return march_rays_hybrid(grid, origins, directions, **kw)
    if takes_kernels(origins.device, shard):
        _check_fka(fka)
        plan = _window_plan(grid, n_samples, near, far, coarse_factor, aabb_extent)
        lo, hi, perm, inv = mk.march_buckets_cuda(
            origins, directions, grid.aabb, grid.binary, n_samples, near, far, cut, (w_lo, k_lo),
            (w_cap, k), occ_stride=occ_stride, coarse=plan)
        # the chain's gradient path: the origins taken through perm, then cut
        o_s = origins.index_select(0, perm) if origins.requires_grad else origins
        return BucketedRays(lo=_kernel_rays(lo, o_s[:cut]), hi=_kernel_rays(hi, o_s[cut:]),
                            inv=inv, perm=perm)
    mk.count_chain()
    perm, st_s, ah_s, o_s, d_s = _span_sorted(
        grid, origins, directions, n_samples, near, far, coarse_factor, aabb_extent
    )
    lo, hi = (slice(0, cut), slice(cut, n_rays)) if shard is None else _bucket_shares(
        n_rays, cut, shard)
    m_lo = _hybrid_fine(grid, o_s[lo], d_s[lo], st_s[lo], ah_s[lo],
                        n_samples, near, far, k_lo, w_lo, occ_stride, fka)
    m_hi = _hybrid_fine(grid, o_s[hi], d_s[hi], st_s[hi], ah_s[hi],
                        n_samples, near, far, k, w_cap, occ_stride, fka)
    if shard is None:
        return BucketedRays(lo=m_lo, hi=m_hi, inv=torch.argsort(perm), perm=perm)
    rows = torch.cat([perm[lo], perm[hi]])
    ident = torch.arange(rows.shape[0], device=rows.device)
    return BucketedRays(lo=m_lo, hi=m_hi, inv=ident, perm=ident), rows


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
