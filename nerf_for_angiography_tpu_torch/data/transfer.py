"""X-ray transfer functions mapping volume scalars to attenuation (port of
``nerf_for_angiography_tpu/data/transfer.py``; phantomdata/helpers.py:17-18
and 33-70).

``transfer_func_ct`` is the piecewise-linear HU -> attenuation curve with its
'binary' (vessels only) and 'background' variants, clamped at both ends as
``jnp.interp`` clamps; torch has no ``interp``, so the segment is found with
``bucketize`` and the line evaluated with ``interp``'s own formula.
"""

from __future__ import annotations

import torch

# breakpoints from helpers.py:36-41
_XS = (0.0, 753.0, 1585.85, 2332.9, 3306.18, 4000.0)
# 'disappearing vessels' curve, used for all experiments (helpers.py:52-59)
_YS_BACKGROUND = (0.0, 0.0, 0.05, 0.0, 0.2, 0.4)
# binary curve (helpers.py:44-50)
_YS_BINARY = (0.0, 0.0, 0.0, 0.0, 0.2, 0.4)


def _f32(vals) -> torch.Tensor:
    return torch.as_tensor(vals, dtype=torch.float32)


def transfer_func_ct(vals, binary: bool = False) -> torch.Tensor:
    """Piecewise-linear CT transfer function (helpers.py:33-70): values
    below the first breakpoint map to its y, above the last to the last y."""
    x = _f32(vals)
    xs = torch.tensor(_XS, dtype=torch.float32, device=x.device)
    ys = torch.tensor(_YS_BINARY if binary else _YS_BACKGROUND, dtype=torch.float32,
                      device=x.device)
    i = torch.bucketize(x, xs, right=True).clamp(1, len(_XS) - 1)
    x0, y0 = xs[i - 1], ys[i - 1]
    f = y0 + ((x - x0) / (xs[i] - x0)) * (ys[i] - y0)
    f = torch.where(x < xs[0], ys[0], f)
    return torch.where(x > xs[-1], ys[-1], f)


def rev_sigmoid(x, c1: float = 1.0, c2: float = 0.0) -> torch.Tensor:
    """Reverse sigmoid SDF -> attenuation transfer 1 / (1 + exp(c1 (x - c2)))
    in f32 (helpers.py:17-18; c1 = 2 for the LCA SDF, helpers.py:93)."""
    return 1.0 / (1.0 + torch.exp(c1 * (_f32(x) - c2)))
