"""Rendering helpers (port of the parts of
``nerf_for_angiography_tpu/ops/rendering.py`` the dense training path uses)."""

from __future__ import annotations

import torch


def psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    """PSNR = -10 log10(mse) (run_nerf_acc.py:303, visualization.py:408)."""
    return -10.0 * torch.log10(mse)
