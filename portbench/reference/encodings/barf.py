"""``pos_enc='barf'``: BARF's coarse-to-fine positional encoding (Lin et
al., ICCV 2021, "BARF: Bundle-Adjusting Neural Radiance Fields"), as the
reference CPPN encodes its positions (model/CPPN.py:224-259, the window's
schedule in nerf/run_nerf_acc.py:165-167 and 268-272).

With L bands (``pos_enc_basis``), row j of the 3L rows encodes channel
j mod 3 at band k = j div 3:

    [x, w_k sin(2^k pi x_c), w_k cos(2^k pi x_c)]

The window w opens band by band as alpha runs from 0 at ``barf_start`` to L
at ``barf_stop`` (float32: alpha = (step - barf_start) * (L / (barf_stop -
barf_start)), clipped to [0, L]): w_k = 0 while alpha < k + 1, then
(1 - cos((alpha - k + 1) 3.1415)) / 2 while alpha < k + 2 (the reference's
literal 3.1415, not pi), then 1. The window is a schedule of the step: the
encoding has no learnable leaves.
"""

from __future__ import annotations

import math

import torch

BARF_PI = 3.1415  # the reference's literal (CPPN.py:252)


def bands(train: dict) -> int:
    return int(train.get("pos_enc_basis", 5))


def in_dim(train: dict) -> int:
    return 3 + 6 * bands(train)


def leaves(gen: torch.Generator, train: dict) -> list[torch.Tensor]:
    return []


def alpha(step: int, train: dict) -> torch.Tensor:
    """The window's alpha at ``step``, float32."""
    n = bands(train)
    start, stop = int(train.get("barf_start", 8000)), int(train.get("barf_stop", 250_000))
    slope = torch.tensor(n / float(stop - start), dtype=torch.float32)
    a = (torch.tensor(float(step), dtype=torch.float32) - float(start)) * slope
    return torch.clamp(a, 0.0, float(n))


def window(step: int, train: dict) -> torch.Tensor:
    """w_k of each of the 3L rows at ``step``, float32 (3L,)."""
    a = alpha(step, train)
    k = torch.arange(bands(train), dtype=torch.float32).repeat_interleave(3)
    mid = (1.0 - torch.cos((a - k + 1.0) * BARF_PI)) / 2.0
    return torch.where(a - (k + 1.0) < 0.0, torch.zeros_like(mid),
                       torch.where(a - (k + 1.0) < 1.0, mid, torch.ones_like(mid)))


def encode(x: torch.Tensor, leaves, step: int, train: dict) -> torch.Tensor:
    n = bands(train)
    k = torch.arange(n, dtype=torch.float32, device=x.device).repeat_interleave(3)
    w = window(step, train).to(x.device)
    v = (torch.pow(2.0, k) * math.pi) * torch.cat([x] * n, dim=-1)
    return torch.cat([x, w * torch.sin(v), w * torch.cos(v)], dim=-1)
