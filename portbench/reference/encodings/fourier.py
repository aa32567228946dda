"""``pos_enc='fourier'``: learnable Gaussian Fourier features (Tancik et al.,
NeurIPS 2020, "Fourier Features Let Networks Learn High Frequency Functions
in Low Dimensional Domains"), as the reference CPPN encodes its positions
(model/CPPN.py:216; L = 5 bands and sigma = 5 by nerf/run_nerf_acc.py:160-167).

With L bands (``pos_enc_basis``) and the learnable coefficients b, a (3L,)
vector, the scaled position x (3 channels) is encoded as

    [x, sin(2 pi b * tile(x, L)), cos(2 pi b * tile(x, L))]

where tile repeats x L times: row j of the 3L rows encodes channel j mod 3
at band j div 3. b starts as sigma (``fourier_sigma``) times standard
normals, drawn after the MLP's weights from the same generator, and trains
with the MLP.
"""

from __future__ import annotations

import math

import torch


def bands(train: dict) -> int:
    return int(train.get("pos_enc_basis", 5))


def in_dim(train: dict) -> int:
    return 3 + 6 * bands(train)


def leaves(gen: torch.Generator, train: dict) -> list[torch.Tensor]:
    b = torch.randn((3 * bands(train),), generator=gen, dtype=torch.float32)
    return [b * float(train.get("fourier_sigma", 5.0))]


def encode(x: torch.Tensor, leaves, step: int, train: dict) -> torch.Tensor:
    (b,) = leaves
    v = 2.0 * math.pi * torch.cat([x] * bands(train), dim=-1) * b
    return torch.cat([x, torch.sin(v), torch.cos(v)], dim=-1)
