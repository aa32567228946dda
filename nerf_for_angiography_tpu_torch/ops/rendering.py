"""X-ray / NeRF volume rendering core in torch (port of
``nerf_for_angiography_tpu/ops/rendering.py``; the reference's
nerf/nerf_helpers.py:47-243 and nerf_helpers_acc.py:45-63).

Fixed-width masked sample tensors (n_rays, n_samples) stand in for nerfacc's
ragged sample lists: per-ray transmittance is ``exp(-sum(sigma * mask *
dt))``, the Beer-Lambert product in log space. The hierarchical resampler
takes its uniforms from an explicit ``torch.Generator``; ``sample_pdf_at``
is its arithmetic on given uniforms, so the tests feed it JAX's draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def cumprod_exclusive(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative product along the last axis.
    Ref: nerf_helpers.py:47-57."""
    cp = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)


def sigma_activation(radiance_field: torch.Tensor) -> torch.Tensor:
    """The X-ray branch's density activation: sigmoid of a 1-channel output
    (nerf_helpers.py:91,95), relu of the mean of a multi-channel "ensemble"
    (nerf_helpers.py:86-88)."""
    if radiance_field.shape[-1] > 1:
        return torch.relu(radiance_field.mean(dim=-1))
    return torch.sigmoid(radiance_field[..., -1])


def segment_dists(depth_values: torch.Tensor, directions: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """dists with the reference's 1e10 last segment, optionally scaled by
    |direction| to real-world length. Ref: nerf_helpers.py:60-65."""
    d = torch.cat([depth_values[..., 1:] - depth_values[..., :-1],
                   torch.full_like(depth_values[..., :1], 1e10)], dim=-1)
    if directions is not None:
        d = d * torch.linalg.norm(directions, dim=-1, keepdim=True)
    return d


class XRayRender(NamedTuple):
    pixels: torch.Tensor  # (n_rays,) transmittance = prod(exp(-sigma*dt))
    depth: torch.Tensor  # (n_rays,)
    weights: torch.Tensor  # (n_rays, n_samples)
    entropy: torch.Tensor  # (n_rays,) masked ray entropy


def render_xray(
    sigma: torch.Tensor, depth_values: torch.Tensor, directions: torch.Tensor | None = None,
    mask: torch.Tensor | None = None, dists: torch.Tensor | None = None,
) -> XRayRender:
    """Beer-Lambert line-integral rendering of an attenuation field
    (nerf_helpers.py:107-116, nerf_helpers_acc.py:45-63): pixel =
    exp(-sum_i sigma_i dt_i) over the samples ``mask`` keeps (masked samples
    are empty space). ``dists`` overrides the depth differences."""
    if dists is None:
        dists = segment_dists(depth_values, directions)
    dists = torch.broadcast_to(dists, sigma.shape)
    tau = sigma * dists  # optical depth per segment
    if mask is not None:
        tau = tau * mask
    alpha = torch.exp(-tau)
    pixels = torch.exp(-tau.sum(dim=-1))
    # weights = (1 - alpha + 1e-10) T_i with T_i = prod_{j<i} alpha_j, the
    # exclusive cumsum by a shift (not cumsum - tau: the reference's 1e10
    # last segment makes that cancel catastrophically in f32)
    tau_cum = torch.cumsum(tau, dim=-1)
    tau_excl = torch.cat([torch.zeros_like(tau_cum[..., :1]), tau_cum[..., :-1]], dim=-1)
    weights = (1.0 - alpha + 1e-10) * torch.exp(-tau_excl)
    depth = (alpha * torch.broadcast_to(depth_values, sigma.shape)).sum(dim=-1)
    entropy = ray_entropy(sigma if mask is None else sigma * mask, pixels)
    return XRayRender(pixels=pixels, depth=depth, weights=weights, entropy=entropy)


def ray_entropy(sigmas: torch.Tensor, pixel_values: torch.Tensor, threshold: float = 0.4
                ) -> torch.Tensor:
    """Entropy of each ray's density distribution, gated (without a
    gradient) to rays whose attenuation 1 - pixel exceeds ``threshold``.
    Ref: nerf_helpers.py:125-135."""
    s = sigmas.sum(dim=-1, keepdim=True)
    density = sigmas / (s + 1e-10)
    ent = -(density * torch.log(density + 1e-10)).sum(dim=-1)
    gate = ((1.0 - pixel_values) > threshold).detach()
    return ent * gate


class RGBSigmaRender(NamedTuple):
    rgb: torch.Tensor
    depth: torch.Tensor
    weights: torch.Tensor
    entropy: torch.Tensor


def render_rgb_sigma(radiance_field: torch.Tensor, depth_values: torch.Tensor,
                     entropy_threshold: float = 0.7) -> RGBSigmaRender:
    """Classic NeRF rgb + sigma rendering, the 2-channel branch, with the
    reference's raw (not direction-scaled) dists. Ref: nerf_helpers.py:67-83."""
    dists = segment_dists(depth_values)
    sigma = torch.relu(radiance_field[..., -1])
    rgb = torch.sigmoid(radiance_field[..., :-1])
    alpha = 1.0 - torch.exp(-sigma * torch.broadcast_to(dists, sigma.shape))
    weights = alpha * cumprod_exclusive(1.0 - alpha + 1e-10)
    rgb_map = torch.squeeze((weights[..., None] * rgb).sum(dim=-2))
    depth_map = (weights * torch.broadcast_to(depth_values, sigma.shape)).sum(dim=-1)
    alpha_sum = alpha.sum(dim=-1)
    density = alpha / (alpha_sum[..., None] + 1e-10)
    ent = -(density * torch.log(density + 1e-10)).sum(dim=-1)
    gate = (alpha_sum > entropy_threshold).detach()
    return RGBSigmaRender(rgb=rgb_map, depth=depth_map, weights=weights, entropy=ent * gate)


def pdf_uniforms(weights: torch.Tensor, n_samples: int, generator: torch.Generator | None
                 ) -> torch.Tensor:
    """The random part of sample_pdf: (..., n_samples) uniforms in [0, 1)
    for coarse ``weights`` (..., n_bins - 1)."""
    return torch.rand(weights.shape[:-1] + (n_samples,), dtype=weights.dtype,
                      device=weights.device, generator=generator)


def sample_pdf_at(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The arithmetic of sample_pdf at given uniforms u (..., n_samples):
    the inverse of the piecewise-linear cdf of ``weights`` + 1e-5 over the
    bin midpoints ``bins`` (..., n_bins)."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    # searchsorted(side='right'): the count of cdf entries <= u
    inds = (u[..., :, None] >= cdf[..., None, :]).sum(dim=-1)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    last = bins.shape[-1] - 1
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=last))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=last))
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverse-CDF (hierarchical) resampling: bins (..., n_bins) sorted
    midpoints, weights (..., n_bins - 1) -> (..., n_samples) fine depths.
    Ref: nerf_helpers.py:197-222."""
    return sample_pdf_at(bins, weights, pdf_uniforms(weights, n_samples, generator))


def fine_sampling_at(depth_values: torch.Tensor, weights_coarse: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """fine_sampling at given uniforms u (..., n_fine)."""
    if depth_values.dim() == 1:
        depth_values = torch.broadcast_to(
            depth_values, weights_coarse.shape[:-1] + depth_values.shape)
    mids = 0.5 * (depth_values[..., 1:] + depth_values[..., :-1])
    fine = sample_pdf_at(mids, weights_coarse[..., 1:-1], u).detach()
    return torch.sort(torch.cat([depth_values, fine], dim=-1), dim=-1).values


def fine_sampling(depth_values: torch.Tensor, weights_coarse: torch.Tensor, n_fine: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Hierarchical fine depths: the coarse depths and ``n_fine``
    inverse-CDF samples of the coarse weights, sorted, without a gradient
    through the new samples (nerf_helpers.py:178-195, its bit-rot fixed)."""
    u = pdf_uniforms(weights_coarse[..., 1:-1], n_fine, generator)
    return fine_sampling_at(depth_values, weights_coarse, u)


def ndc_rays(sample_size: float, focal_length: float, near_thresh: float,
             origins: torch.Tensor, directions: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized-device-coordinate ray warp. Ref: nerf_helpers.py:224-243."""
    t = -(near_thresh + origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions
    scale = -1.0 / (sample_size / (2.0 * focal_length))
    o0 = scale * origins[..., 0] / origins[..., 2]
    o1 = scale * origins[..., 1] / origins[..., 2]
    o2 = 1.0 + 2.0 * near_thresh / origins[..., 2]
    d0 = scale * (directions[..., 0] / directions[..., 2] - origins[..., 0] / origins[..., 2])
    d1 = scale * (directions[..., 1] / directions[..., 2] - origins[..., 1] / origins[..., 2])
    d2 = -2.0 * near_thresh / origins[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    """PSNR = -10 log10(mse) (run_nerf_acc.py:303, visualization.py:408)."""
    return -10.0 * torch.log10(mse)
