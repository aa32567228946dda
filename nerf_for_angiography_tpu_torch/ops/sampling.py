"""On-device ray-batch sampling in torch (port of
``nerf_for_angiography_tpu/ops/sampling.py``).

Random draws come from an explicit ``torch.Generator`` on the data's
device; they do not reproduce JAX's threefry bits, so each sampler is split
into its draw and its selection, and the tests feed the selection JAX's own
draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class RayDataset(NamedTuple):
    """Dense ray store, one row per pixel across all views (the per-ray CSV
    schema of cttoray.py:303-306)."""

    origins: torch.Tensor  # (N, 3) f32
    directions: torch.Tensor  # (N, 3) f32
    pixel_values: torch.Tensor  # (N,) f32
    weights: torch.Tensor  # (N,) f32 distance_pixel_value sampling weights
    image_ids: torch.Tensor  # (N,) int64 view index
    x_positions: torch.Tensor  # (N,) int64
    y_positions: torch.Tensor  # (N,) int64
    # inverse-CDF table (build_sampling_table) for the 'overdraw' sampler
    sampling_table: torch.Tensor | None = None

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    def to(self, device) -> "RayDataset":
        return RayDataset(*(None if t is None else t.to(device) for t in self))


class RayBatch(NamedTuple):
    origins: torch.Tensor
    directions: torch.Tensor
    pixel_values: torch.Tensor
    image_ids: torch.Tensor


def gumbel_topk_indices(
    generator: torch.Generator, weights: torch.Tensor, n: int
) -> torch.Tensor:
    """Weighted sample without replacement of size n via Gumbel top-k
    (pandas ``.sample(n, weights)`` semantics, nerf_helpers.py:139)."""
    u = torch.rand(weights.shape, generator=generator, device=weights.device)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    scores = torch.log(torch.clamp(weights, min=1e-30)) + g
    return torch.topk(scores, n).indices


def build_sampling_table(weights: torch.Tensor, table_size: int = 1 << 18) -> torch.Tensor:
    """Quantized inverse-CDF table: table[j] = smallest i with
    cdf[i] >= (j + 0.5) / table_size."""
    cdf = torch.cumsum(weights.to(torch.float32), 0)
    cdf = cdf / cdf[-1]
    u = (torch.arange(table_size, dtype=torch.float32, device=weights.device) + 0.5) / table_size
    return torch.searchsorted(cdf, u)


def overdraw_draws(
    generator: torch.Generator, table_size: int, n: int, oversample: float = 1.125,
    device=None,
) -> torch.Tensor:
    """The random part of the overdraw sampler: ceil(n * oversample) uniform
    table slots (``jax.random.randint(key, (m,), 0, t)`` in the JAX one)."""
    m = int(math.ceil(n * oversample))
    return torch.randint(0, table_size, (m,), generator=generator, device=device)


def overdraw_select(
    table: torch.Tensor, draws: torch.Tensor, n: int, n_values: int
) -> torch.Tensor:
    """The deterministic part: map draws through the table, keep the first n
    unique ray indices in draw order (then, in the rare shortfall, the
    earliest duplicates in draw order)."""
    m = draws.shape[0]
    idx = table[draws]
    pos = torch.arange(m, device=idx.device)
    first = torch.full((n_values,), m, dtype=pos.dtype, device=idx.device)
    first = first.scatter_reduce(0, idx, pos, reduce="amin")
    uniq = first[idx] == pos
    rank_u = torch.cumsum(uniq.to(torch.int64), 0) - 1
    n_uniq = rank_u[-1] + 1
    rank_d = pos - rank_u - 1
    slot = torch.where(uniq, rank_u, n_uniq + rank_d)
    slot = torch.where(slot < n, slot, torch.full_like(slot, n))
    out = torch.zeros((n + 1,), dtype=idx.dtype, device=idx.device)
    # slots < n are unique; only the spill slot n receives several writes
    out[slot] = idx
    return out[:n]


def overdraw_sample_indices(
    generator: torch.Generator, table: torch.Tensor, n: int, n_values: int,
    oversample: float = 1.125,
) -> torch.Tensor:
    """Fast approximate weighted sample without replacement of size n:
    overdraw with replacement through the inverse-CDF table, then dedupe
    (``n_values`` = the number of rays the table maps into)."""
    draws = overdraw_draws(generator, table.shape[0], n, oversample, table.device)
    return overdraw_select(table, draws, n, n_values)


def sample_pixel_rays(
    generator: torch.Generator, data: RayDataset, n: int, weighted: bool = True,
    impl: str = "gumbel",
) -> RayBatch:
    """Sample n rays from the pixels of all training views
    (nerf_helpers.py:137-150)."""
    if impl == "overdraw" and weighted and data.sampling_table is not None:
        idx = overdraw_sample_indices(
            generator, data.sampling_table, n, n_values=data.num_rays
        )
    else:
        w = data.weights if weighted else torch.ones_like(data.weights)
        idx = gumbel_topk_indices(generator, w, n)
    return RayBatch(
        origins=data.origins[idx],
        directions=data.directions[idx],
        pixel_values=data.pixel_values[idx],
        image_ids=data.image_ids[idx],
    )
