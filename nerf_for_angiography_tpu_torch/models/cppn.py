"""CPPN coordinate field as a torch ``nn.Module`` (port of
``nerf_for_angiography_tpu/models/cppn.py``).

This slice covers the flagship density stack: ``act_func='relu'``,
``pos_enc='none'``, no view branch and no late layers. Parameter names
follow the flax module (``input_layer``, ``early_i``, ``output_linear``,
``img1``, ``img2``) so weights carry across one to one (``convert.py``).
Initialisation matches flax in distribution (lecun_normal kernels — a
truncated normal of variance 1/fan_in — and zero biases), not in bits.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class CPPNConfig:
    """Model definition; field names mirror the reference's model_definition
    dict (run_nerf_acc.py:168-183). ``dtype`` is the compute dtype of the
    plain path (parameters are float32)."""

    num_early_layers: int = 4
    num_late_layers: int = 0
    num_filters: int = 128
    num_input_channels: int = 3
    num_input_channels_views: int = 0
    num_output_channels: int = 1
    use_bias: bool = True
    pos_enc: str = "none"  # 'none' | 'fourier' | 'barf'
    pos_enc_basis: int = 5
    pos_enc_basis_views: int = 4
    act_func: str = "relu"  # 'relu' | 'sine' | 'tanh'
    sine_w0: float = 30.0
    fourier_sigma: float = 5.0
    num_img: int = 1
    dtype: torch.dtype = torch.float32
    # scale raw world coords (e.g. +-100 mm) into ~[-1, 1] before the MLP so
    # bf16 activations keep sub-voxel resolution
    input_scale: float = 1.0

    @property
    def use_viewdirs(self) -> bool:
        return self.num_input_channels_views > 0


def _check_ported(cfg: CPPNConfig) -> None:
    if cfg.pos_enc != "none":
        raise NotImplementedError(
            f"pos_enc={cfg.pos_enc!r} arrives with slice 4 (fourier/BARF encodings)"
        )
    if cfg.act_func != "relu":
        raise NotImplementedError(
            f"act_func={cfg.act_func!r} arrives with the classic-path slice"
        )
    if cfg.use_viewdirs or cfg.num_late_layers > 0:
        raise NotImplementedError(
            "view branch / late layers arrive with the classic-path slice"
        )
    if not cfg.use_bias:
        raise NotImplementedError("use_bias=False is not ported")


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's lecun_normal: truncated normal (+-2 std) with variance
    1/fan_in; ``weight`` is (out, in)."""
    fan_in = weight.shape[1]
    # std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(
            weight, mean=0.0, std=std, a=-2 * std, b=2 * std, generator=generator
        )


class CPPN(nn.Module):
    """Coordinate MLP: (x, y, z) -> 1-channel raw density."""

    def __init__(self, config: CPPNConfig, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        _check_ported(config)
        self.config = config
        f = config.num_filters
        kw = dict(device=device, dtype=torch.float32)
        self.input_layer = nn.Linear(config.num_input_channels, f, **kw)
        for i in range(config.num_early_layers):
            setattr(self, f"early_{i}", nn.Linear(f, f, **kw))
        self.output_linear = nn.Linear(f, config.num_output_channels, **kw)
        # per-image learnable translations, parity with CPPN.py:133-135
        self.img1 = nn.Parameter(torch.zeros(2, **kw))
        self.img2 = nn.Parameter(torch.zeros(2, **kw))
        for lin in self.linears():
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def linears(self) -> list[nn.Linear]:
        n = self.config.num_early_layers
        return (
            [self.input_layer]
            + [getattr(self, f"early_{i}") for i in range(n)]
            + [self.output_linear]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., 3) world coords -> (..., num_output_channels) float32, in
        the compute dtype of the config (flax Dense with ``dtype``: inputs,
        weights and biases cast, result rounded to that dtype per layer)."""
        dt = self.config.dtype
        h = (x[..., : self.config.num_input_channels] * self.config.input_scale).to(dt)
        *hidden, out = self.linears()
        for lin in hidden:
            h = torch.relu(nn.functional.linear(h, lin.weight.to(dt), lin.bias.to(dt)))
        h = nn.functional.linear(h, out.weight.to(dt), out.bias.to(dt))
        return h.to(torch.float32)
