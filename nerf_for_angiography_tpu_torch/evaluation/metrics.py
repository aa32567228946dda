"""Image and volume quality metrics in torch (port of
``nerf_for_angiography_tpu/evaluation/metrics.py``).

The reference's metric stack (visualization.py:406-505): PSNR, SSIM
(torchmetrics defaults: 11-tap gaussian, sigma 1.5, data_range 1), DICE
2D/3D as torchmetrics Dice(average='micro'), DOT 2D/3D with min-max
normalisation. LPIPS and DISTS live in ``perceptual.py``.

Each metric reduces over its whole input, as the JAX functions do. The
``*_views`` forms take a stack of views (V, ...) and give one value a view,
each the value the one-view function gives for that view: the sweep scores
a batch of views in one call on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(V, ...) -> (V, n): one flat row a view."""
    return x.reshape(x.shape[0], -1)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """PSNR = -10 log10(mse), the reference's form (visualization.py:406-409)."""
    return -10.0 * torch.log10(mse(pred, target))


def psnr_views(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """psnr of each view of (V, ...) stacks -> (V,)."""
    return -10.0 * torch.log10(torch.mean((_rows(pred) - _rows(target)) ** 2, dim=1))


def _gaussian_kernel1d(size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural similarity of two 2D images (H, W) -> scalar, or of two
    stacks of views (V, H, W) -> (V,).

    torchmetrics StructuralSimilarityIndexMeasure defaults as
    visualization.py:266-267,411-417 use them: a gaussian window, the Wang
    et al. formula, the mean over the valid positions (``conv2d`` without
    padding, JAX's ``VALID``)."""
    one = pred.dim() == 2
    p = (pred[None] if one else pred).to(torch.float32)[:, None]  # (V, 1, H, W)
    t = (target[None] if one else target).to(torch.float32)[:, None]
    g = _gaussian_kernel1d(kernel_size, sigma, p.device)
    kern = torch.outer(g, g)[None, None]  # (1, 1, k, k)

    def filt(x):
        if min(x.shape[-2:]) < kernel_size:  # no valid position: JAX's mean is NaN
            return x.new_empty(x.shape[:2] + (0, 0))
        return F.conv2d(x, kern)

    mu_p = filt(p)
    mu_t = filt(t)
    mu_pp = filt(p * p)
    mu_tt = filt(t * t)
    mu_pt = filt(p * t)

    # f32 cancellation on near-constant windows (large white background in
    # DRRs) can make E[x^2]-E[x]^2 slightly negative and push SSIM above 1;
    # clamp to the feasible region (var >= 0, |cov| <= sqrt(var_p*var_t))
    var_p = torch.clamp(mu_pp - mu_p**2, min=0.0)
    var_t = torch.clamp(mu_tt - mu_t**2, min=0.0)
    cov_bound = torch.sqrt(var_p * var_t)
    cov = torch.clamp(mu_pt - mu_p * mu_t, -cov_bound, cov_bound)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p**2 + mu_t**2 + c1) * (var_p + var_t + c2)
    s = torch.mean(_rows(num / den), dim=1)
    return s[0] if one else s


def dice_micro_views(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """dice_micro of each view of (V, ...) class maps -> (V,)."""
    p = _rows(pred.to(torch.int32))
    t = _rows(target.to(torch.int32))
    tp = torch.sum(p == t, dim=1).to(torch.float32)
    errs = torch.sum(p != t, dim=1).to(torch.float32)
    return 2.0 * tp / (2.0 * tp + errs + errs)


def dice_micro(pred: torch.Tensor, target: torch.Tensor, num_classes: int = 2) -> torch.Tensor:
    """Micro-averaged Dice over integer class maps.

    torchmetrics Dice(average='micro') semantics (visualization.py:241,439):
    TP/FP/FN are summed over ALL classes, so for dense label maps micro-dice
    reduces to 2*matches / (2*matches + mismatches + mismatches) =
    accuracy. Kept verbatim for df-metrics.csv parity."""
    return dice_micro_views(pred.reshape(1, -1), target.reshape(1, -1))[0]


def dice_binary(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Classic foreground Dice 2|A∩B|/(|A|+|B|), beside the micro variant
    for actual overlap analysis."""
    p = pred.to(torch.bool).reshape(-1)
    t = target.to(torch.bool).reshape(-1)
    inter = torch.sum(p & t).to(torch.float32)
    total = torch.sum(p) + torch.sum(t)
    return torch.where(total > 0, 2.0 * inter / total, torch.ones_like(inter))


def _minmax_rows(x: torch.Tensor) -> torch.Tensor:
    x = x - torch.amin(x, dim=1, keepdim=True)
    mx = torch.amax(x, dim=1, keepdim=True)
    return torch.where(mx > 0, x / mx, x)


def dot_score_views(pred: torch.Tensor, target: torch.Tensor,
                    normalize: bool = True) -> torch.Tensor:
    """dot_score of each view of (V, ...) stacks -> (V,)."""
    p, t = _rows(pred), _rows(target)
    if normalize:
        p, t = _minmax_rows(p), _minmax_rows(t)
    return torch.mean(p * t, dim=1)


def dot_score(pred: torch.Tensor, target: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Mean elementwise product, optionally after min-max normalisation: the
    reference's 'DOT 2D/3D' (visualization.py:442-454,493-495).

    As in the JAX package, DOT 3D is normalised too (the reference's is a
    raw mean product, visualization.py:493-495), so it is comparable across
    transfer functions; ``normalize=False`` gives the reference's raw value."""
    return dot_score_views(pred.reshape(1, -1), target.reshape(1, -1), normalize)[0]


def binarize(img: torch.Tensor, threshold: float = 1.0) -> torch.Tensor:
    """The reference's DICE pre-binarisation: values < threshold -> 0
    (visualization.py:436-437)."""
    return (img >= threshold).to(torch.int32)
