"""Importance-weight maps for ray sampling (Frangi vesselness + EDT); a
numpy/scipy copy of ``nerf_for_angiography_tpu/data/weights.py``.

Semantics of phantomdata/helpers.py:226-247 (``get_weighted_img``):
  frangi strategy      -> Frangi vesselness filter of the DRR
  segmentation strategy-> binary mask of attenuated pixels (img < 1)
  random strategy      -> uniform weights (cttoray.py:221)
then normalize, Euclidean distance transform, normalize, += 1e-10.

skimage is not available in this image, so the 2D Frangi filter is
implemented here directly (multiscale Hessian eigenvalue vesselness,
Frangi et al. 1998) on top of scipy.ndimage Gaussian derivatives — same
algorithm skimage implements, defaults matched to skimage.filters.frangi
(sigmas=1..10 step 2, black_ridges=True, gamma=15). Cold path: runs host-side
in numpy once per view during datagen.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def hessian_2d(img: np.ndarray, sigma: float):
    """Scale-normalized Hessian via Gaussian derivatives (sigma^2 * d2G)."""
    img = img.astype(np.float64)
    hxx = ndimage.gaussian_filter(img, sigma, order=(2, 0), mode="reflect")
    hxy = ndimage.gaussian_filter(img, sigma, order=(1, 1), mode="reflect")
    hyy = ndimage.gaussian_filter(img, sigma, order=(0, 2), mode="reflect")
    s2 = sigma * sigma
    return s2 * hxx, s2 * hxy, s2 * hyy


def _hessian_eigvals_2d(hxx, hxy, hyy):
    """Eigenvalues of the symmetric 2x2 Hessian, sorted by |.| ascending."""
    tr = hxx + hyy
    disc = np.sqrt(((hxx - hyy) / 2.0) ** 2 + hxy**2)
    l1 = tr / 2.0 + disc
    l2 = tr / 2.0 - disc
    # sort by absolute value: lam1 = smaller |.|, lam2 = larger |.|
    swap = np.abs(l1) > np.abs(l2)
    lam1 = np.where(swap, l2, l1)
    lam2 = np.where(swap, l1, l2)
    return lam1, lam2


def frangi(
    img: np.ndarray,
    sigmas=(1, 3, 5, 7, 9),
    alpha: float = 0.5,
    beta: float = 0.5,
    gamma: float = 15.0,
    black_ridges: bool = True,
) -> np.ndarray:
    """2D Frangi vesselness. Ref call site: helpers.py:228 (frangi(img,
    alpha=.., beta=..)); in 2D skimage's alpha is unused, matched here.

    V = exp(-Rb^2 / 2 beta^2) * (1 - exp(-S^2 / 2 gamma^2)) where
    Rb = |lam1| / |lam2|, S = sqrt(lam1^2 + lam2^2); zero where the ridge
    polarity does not match (lam2 < 0 for black ridges after negation).
    """
    img = np.asarray(img, np.float64)
    if black_ridges:
        img = -img
    out = np.zeros_like(img)
    for sigma in sigmas:
        lam1, lam2 = _hessian_eigvals_2d(*hessian_2d(img, sigma))
        lam2_safe = np.where(lam2 == 0, 1e-10, lam2)
        rb2 = (lam1 / lam2_safe) ** 2
        s2 = lam1**2 + lam2**2
        v = np.exp(-rb2 / (2 * beta**2)) * (1 - np.exp(-s2 / (2 * gamma**2)))
        v = np.where(lam2 < 0, v, 0.0)  # bright(negated) tubular structures
        out = np.maximum(out, v)
    return out


def get_weighted_img(
    img: np.ndarray,
    frangi_alpha: float | None,
    frangi_beta: float | None,
    sampling_strategy: str = "frangi",
) -> np.ndarray:
    """Importance-weight map of a DRR. Ref: helpers.py:226-247.

    frangi -> vesselness; segmentation -> img < 1 mask; then normalize,
    EDT, normalize, += 1e-10 (reference applies the same post-processing to
    both strategies). 'random' strategy is handled by the caller
    (uniform ones, cttoray.py:221).
    """
    img = np.asarray(img, np.float64)
    if sampling_strategy == "frangi":
        img_binary = frangi(img, alpha=frangi_alpha or 0.5, beta=frangi_beta or 0.5)
    else:
        img_binary = np.zeros_like(img)
        img_binary[img < 1] = 1.0

    img_binary = img_binary - img_binary.min()
    mx = img_binary.max()
    if mx > 0:
        img_binary = img_binary / mx

    img_transf = ndimage.distance_transform_edt(img_binary)
    img_transf = img_transf - img_transf.min()
    mx = img_transf.max()
    if mx > 0:
        img_transf = img_transf / mx
    return img_transf + 1e-10
