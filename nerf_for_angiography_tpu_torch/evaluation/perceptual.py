"""Perceptual metrics: LPIPS and DISTS on a VGG16 backbone in torch (port
of ``nerf_for_angiography_tpu/evaluation/perceptual.py``).

The reference computes these through ``piq`` with torchvision's pretrained
VGG16 (visualization.py:21,269-273,419-433). The repo holds no pretrained
weights, so the backbone is built here on ``conv2d`` and the weights are an
input:

  * ``PerceptualMetrics.from_npz(path)`` loads the bundle that
    ``tools/convert_perceptual_weights.py`` writes (VGG16 convs stored HWIO,
    the LPIPS linear weights, optionally DISTS alpha/beta), checked against
    its sha256;
  * ``PerceptualMetrics.uncalibrated(generator)`` draws a fixed random VGG
    (He init from the given ``torch.Generator``). The metric is still a
    deterministic perceptual distance, but its values are not
    piq-comparable, and not the JAX package's uncalibrated values either
    (Philox draws, not threefry): ``calibrated=False`` marks them.

LPIPS: unit-normalise each stage's channels, squared difference, 1x1
learned linear weights, spatial mean, sum over stages (Zhang et al. 2018).
DISTS: per-stage texture (mean) and structure (correlation) similarities
with learned alpha/beta weights (Ding et al. 2020), on the backbone with
average pools (piq's ``replace_pooling=True``).

Images are (H, W) or a stack of views (V, H, W) in [0, 1]; a stack gives one
value a view, each the value of that view alone.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

# VGG16 conv plan: (out_channels, pool_before)
_VGG16_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# feature taps after these conv indices (relu1_2, 2_2, 3_3, 4_3, 5_3)
_TAPS = (1, 3, 6, 9, 12)
_STAGE_CHANNELS = (64, 128, 256, 512, 512)

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _pool(x: torch.Tensor, kind: str) -> torch.Tensor:
    """2x2 stride-2 pool without padding (JAX's reduce_window 'VALID'): an
    odd last row or column is dropped, and a map narrower than 2 pools to
    an empty one, as in JAX (its later means are then NaN)."""
    n, c, h, w = x.shape
    x = x[:, :, : h // 2 * 2, : w // 2 * 2].reshape(n, c, h // 2, 2, w // 2, 2)
    return x.mean(dim=(3, 5)) if kind == "avg" else x.amax(dim=(3, 5))


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 'SAME' convolution; an empty map stays empty."""
    if x.shape[-1] == 0 or x.shape[-2] == 0:
        return x.new_zeros((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))
    return F.conv2d(x, w, b, padding=1)


def vgg16_features(
    params: Sequence[tuple], x: torch.Tensor, pool: str = "max"
) -> list[torch.Tensor]:
    """x (N, 3, H, W) normalised -> the 5 tap feature maps (NCHW).
    ``params``: [(w (O, I, 3, 3), b (O,)), ...]. ``pool='avg'`` replaces the
    max pools with 2x2 average pools (piq's DISTS backbone)."""
    feats = []
    h = x
    for i, ((w, b), (_, pool_here)) in enumerate(zip(params, _VGG16_PLAN)):
        if pool_here:
            h = _pool(h, pool)
        h = torch.relu(_conv(h, w, b))
        if i in _TAPS:
            feats.append(h)
    return feats


def init_vgg16(generator: torch.Generator, device=None) -> list[tuple]:
    """He-init VGG16 conv stack (the uncalibrated mode), OIHW."""
    params = []
    in_c = 3
    for out_c, _ in _VGG16_PLAN:
        w = torch.randn((out_c, in_c, 3, 3), generator=generator, dtype=torch.float32)
        w = w * float(np.sqrt(2.0 / (9 * in_c)))
        params.append((w.to(device), torch.zeros((out_c,), dtype=torch.float32, device=device)))
        in_c = out_c
    return params


def _prep_images(img: torch.Tensor) -> torch.Tensor:
    """(H, W) or (V, H, W) in [0, 1] -> normalised (V, 3, H, W)."""
    x = img.to(torch.float32)
    if x.dim() == 2:
        x = x[None]
    x = x[:, None].expand(-1, 3, -1, -1)
    mean = torch.as_tensor(_IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.as_tensor(_IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def _unit_normalize(f: torch.Tensor) -> torch.Tensor:
    return f / torch.sqrt(torch.sum(f**2, dim=1, keepdim=True) + 1e-10)


def _uniform_dists_weights(device=None) -> tuple[list, list]:
    """DISTS alpha and beta, jointly normalised (sum(alpha) + sum(beta) = 1,
    so dists(x, x) == 0)."""
    n_total = 2 * (sum(_STAGE_CHANNELS) + 3)
    al = [torch.full((c,), 1.0 / n_total, dtype=torch.float32, device=device)
          for c in (3,) + _STAGE_CHANNELS]
    be = [torch.full((c,), 1.0 / n_total, dtype=torch.float32, device=device)
          for c in (3,) + _STAGE_CHANNELS]
    return al, be


@dataclasses.dataclass
class PerceptualMetrics:
    vgg_params: Any  # [(w (O, I, 3, 3), b (O,)), ...] f32
    lpips_weights: Any  # per-stage (C,) nonneg linear weights
    dists_alpha: Any  # per-stage (C,) weights, the input stage first
    dists_beta: Any
    calibrated: bool

    @classmethod
    def uncalibrated(cls, generator: torch.Generator | None = None,
                     device="cuda") -> "PerceptualMetrics":
        """The fixed random VGG (``generator`` defaults to one seeded 1234,
        the JAX package's default key), its weights on ``device``."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(1234)
        vgg = init_vgg16(generator, device)
        lp = [torch.full((c,), 1.0 / c, dtype=torch.float32, device=device)
              for c in _STAGE_CHANNELS]
        al, be = _uniform_dists_weights(device)
        return cls(vgg, lp, al, be, calibrated=False)

    @classmethod
    def from_npz(cls, path: str, sha256: str | None = None,
                 device="cuda") -> "PerceptualMetrics":
        """Load pretrained weights (see tools/convert_perceptual_weights.py).

        Integrity: pass ``sha256`` or ship the converter's ``<path>.sha256``
        sidecar; a mismatched bundle raises instead of silently producing
        wrong (but plausible) metric values. The bundle's HWIO conv weights
        are transposed to OIHW. The weights go to ``device``."""
        device = resolve_device(device)
        expected = sha256
        sidecar = path + ".sha256"
        if expected is None and os.path.exists(sidecar):
            with open(sidecar) as f:
                expected = f.read().split()[0].strip()
        if expected:
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest != expected.lower():
                raise ValueError(
                    f"perceptual weight bundle {path} sha256 mismatch: "
                    f"got {digest}, expected {expected}"
                )

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        with np.load(path) as z:
            vgg = [(t(z[f"conv{i}_w"].transpose(3, 2, 0, 1)), t(z[f"conv{i}_b"]))
                   for i in range(len(_VGG16_PLAN))]
            lp = [t(z[f"lpips{i}"]) for i in range(5)]
            if "dists_alpha0" in z:
                al = [t(z[f"dists_alpha{i}"]) for i in range(6)]
                be = [t(z[f"dists_beta{i}"]) for i in range(6)]
            else:
                al, be = _uniform_dists_weights(device)
        return cls(vgg, lp, al, be, calibrated=True)

    def to(self, device) -> "PerceptualMetrics":
        """A copy with every weight on ``device``."""
        return PerceptualMetrics(
            [(w.to(device), b.to(device)) for w, b in self.vgg_params],
            [w.to(device) for w in self.lpips_weights],
            [a.to(device) for a in self.dists_alpha],
            [b.to(device) for b in self.dists_beta],
            self.calibrated,
        )

    @torch.no_grad()
    def lpips(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """LPIPS distance of two images in [0, 1]: a scalar for (H, W), one
        value a view for (V, H, W)."""
        fp = vgg16_features(self.vgg_params, _prep_images(pred))
        ft = vgg16_features(self.vgg_params, _prep_images(target))
        total = 0.0
        for f1, f2, w in zip(fp, ft, self.lpips_weights):
            d = (_unit_normalize(f1) - _unit_normalize(f2)) ** 2
            total = total + torch.mean(torch.sum(d * w.view(1, -1, 1, 1), dim=1), dim=(1, 2))
        return total[0] if pred.dim() == 2 else total

    @torch.no_grad()
    def dists(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """DISTS distance (1 - weighted structure/texture similarity), shaped
        as lpips."""
        xp = _prep_images(pred)
        xt = _prep_images(target)
        # piq's DISTS backbone swaps max pools for average pools
        # (replace_pooling=True); LPIPS keeps max pooling
        fp = [xp] + vgg16_features(self.vgg_params, xp, pool="avg")
        ft = [xt] + vgg16_features(self.vgg_params, xt, pool="avg")
        c1 = c2 = 1e-6
        sim = 0.0
        for f1, f2, a, b in zip(fp, ft, self.dists_alpha, self.dists_beta):
            mu1 = torch.mean(f1, dim=(2, 3))
            mu2 = torch.mean(f2, dim=(2, 3))
            var1 = torch.mean((f1 - mu1[..., None, None]) ** 2, dim=(2, 3))
            var2 = torch.mean((f2 - mu2[..., None, None]) ** 2, dim=(2, 3))
            cov = torch.mean(f1 * f2, dim=(2, 3)) - mu1 * mu2
            texture = (2 * mu1 * mu2 + c1) / (mu1**2 + mu2**2 + c1)
            structure = (2 * cov + c2) / (var1 + var2 + c2)
            sim = sim + torch.sum(a * texture + b * structure, dim=1)
        out = 1.0 - sim
        return out[0] if pred.dim() == 2 else out
