"""CPPN coordinate field as a torch ``nn.Module`` (port of
``nerf_for_angiography_tpu/models/cppn.py``).

The port covers the density stack with ``act_func='relu'``, no view branch
and no late layers, with ``pos_enc`` 'none', 'fourier' (learnable Gaussian
coefficients) or 'barf' (fixed 2^k pi frequencies under a coarse-to-fine
window that is a pure function of ``barf_alpha``; ref CPPN.py:62-94,207-259).
Parameter names follow the flax module (``input_layer``, ``early_i``,
``output_linear``, ``fourier_coefficients_pts``, ``img1``, ``img2``) so
weights carry across one to one (``convert.py``). Initialisation matches
flax in distribution (lecun_normal kernels — a truncated normal of variance
1/fan_in — zero biases, N(0, fourier_sigma^2) coefficients), not in bits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

# The reference's BARF window uses the literal 3.1415 (CPPN.py:252), not pi.
_BARF_PI = 3.1415


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

    @property
    def encoded_pts_features(self) -> int:
        c = self.num_input_channels
        if self.pos_enc != "none" and self.pos_enc_basis > 0:
            return c + c * 2 * self.pos_enc_basis
        return c

    def to_model_definition(self) -> dict:
        """The reference's model_definition dict, the model bundles'
        metadata (CPPN.py:261-276), as the JAX package writes it."""
        return {
            "num_early_layers": self.num_early_layers,
            "num_late_layers": self.num_late_layers,
            "num_filters": self.num_filters,
            "num_input_channels": self.num_input_channels,
            "num_input_channels_views": self.num_input_channels_views,
            "num_output_channels": self.num_output_channels,
            "use_bias": self.use_bias,
            "pos_enc": self.pos_enc,
            "pos_enc_basis": self.pos_enc_basis,
            "pos_enc_basis_views": self.pos_enc_basis_views,
            "act_func": self.act_func,
            "sine_weights": self.sine_w0,
            "fourier_sigma": self.fourier_sigma,
            "num_img": self.num_img,
        }


def barf_k_values(pos_enc_basis: int, num_channels: int, device=None) -> torch.Tensor:
    """k index per encoded channel: repeat_interleave(arange(L), C).
    Ref: CPPN.py:84."""
    k = torch.arange(pos_enc_basis, dtype=torch.float32, device=device)
    return k.repeat_interleave(num_channels)


def barf_weights(alpha, k_values: torch.Tensor) -> torch.Tensor:
    """Coarse-to-fine BARF frequency window, a pure function of alpha, in
    f32 (ref CPPN.py:244-259): with barf_k = alpha - (k + 1), w = 0 where
    barf_k < 0, (1 - cos((alpha - k + 1) 3.1415)) / 2 where 0 <= barf_k < 1,
    1 where barf_k >= 1."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=k_values.device)
    barf_k = alpha - (k_values + 1.0)
    mid = (1.0 - torch.cos((alpha - k_values + 1.0) * _BARF_PI)) / 2.0
    one = torch.ones_like(mid)
    return torch.where(barf_k < 0.0, torch.zeros_like(mid), torch.where(barf_k < 1.0, mid, one))


def barf_alpha_schedule(step: int, pos_enc_basis: int, barf_start: int = 8000,
                        barf_stop: int = 250000) -> float:
    """Linear BARF alpha annealing, on the host in f32: 0 until barf_start,
    then a ramp to pos_enc_basis at barf_stop. Ref: run_nerf_acc.py:165-167,
    268-272."""
    slope = np.float32(pos_enc_basis / float(barf_stop - barf_start))
    alpha = (np.float32(step) - np.float32(barf_start)) * slope
    return float(np.clip(alpha, np.float32(0.0), np.float32(pos_enc_basis)))


def barf_alpha_device(step: torch.Tensor, pos_enc_basis: int, barf_start: int = 8000,
                      barf_stop: int = 250000) -> torch.Tensor:
    """barf_alpha_schedule at an integer step tensor, on its device: the
    same f32 operations (the f32 slope, a subtraction, a product, a clip),
    so the same value bit for bit."""
    slope = float(np.float32(pos_enc_basis / float(barf_stop - barf_start)))
    alpha = (step.to(torch.float32) - float(barf_start)) * slope
    return torch.clamp(alpha, 0.0, float(pos_enc_basis))


def _check_ported(cfg: CPPNConfig) -> None:
    if cfg.pos_enc not in ("none", "fourier", "barf"):
        raise ValueError(f"unknown pos_enc: {cfg.pos_enc!r}")
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
    """Coordinate MLP: (x, y, z) -> 1-channel raw density, the coordinates
    optionally through the fourier or BARF positional encoding."""

    def __init__(self, config: CPPNConfig, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        _check_ported(config)
        self.config = config
        f = config.num_filters
        kw = dict(device=device, dtype=torch.float32)
        self.input_layer = nn.Linear(config.encoded_pts_features, f, **kw)
        for i in range(config.num_early_layers):
            setattr(self, f"early_{i}", nn.Linear(f, f, **kw))
        self.output_linear = nn.Linear(f, config.num_output_channels, **kw)
        # per-image learnable translations, parity with CPPN.py:133-135
        self.img1 = nn.Parameter(torch.zeros(2, **kw))
        self.img2 = nn.Parameter(torch.zeros(2, **kw))
        for lin in self.linears():
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
        if config.pos_enc == "fourier" and config.pos_enc_basis > 0:
            # learnable Gaussian coefficients ~ N(0, sigma^2) (CPPN.py:70-80)
            n = config.num_input_channels * config.pos_enc_basis
            coeff = torch.randn((n,), generator=generator, dtype=torch.float32)
            self.fourier_coefficients_pts = nn.Parameter(
                (coeff * config.fourier_sigma).to(device)
            )

    def linears(self) -> list[nn.Linear]:
        n = self.config.num_early_layers
        return (
            [self.input_layer]
            + [getattr(self, f"early_{i}") for i in range(n)]
            + [self.output_linear]
        )

    def forward(self, x: torch.Tensor, barf_alpha=0.0) -> torch.Tensor:
        """x (..., 3) world coords -> (..., num_output_channels) float32: the
        encode in f32, then the layers in the compute dtype of the config
        (flax Dense with ``dtype``: inputs, weights and biases cast, result
        rounded to that dtype per layer). ``barf_alpha`` sets the BARF
        window."""
        dt = self.config.dtype
        pts = x[..., : self.config.num_input_channels] * self.config.input_scale
        h = self._pos_enc(pts, barf_alpha).to(dt)
        *hidden, out = self.linears()
        for lin in hidden:
            h = torch.relu(nn.functional.linear(h, lin.weight.to(dt), lin.bias.to(dt)))
        h = nn.functional.linear(h, out.weight.to(dt), out.bias.to(dt))
        return h.to(torch.float32)

    def _pos_enc(self, values: torch.Tensor, alpha) -> torch.Tensor:
        """concat([x, enc(tile(x, L))]) in f32, as flax's _pos_enc (ref
        CPPN.py:207-234): feature order [x, sin rows, cos rows], row j
        encoding coordinate j % 3 at band j // 3."""
        cfg = self.config
        basis = cfg.pos_enc_basis
        if cfg.pos_enc == "none" or basis <= 0:
            return values
        tiled = torch.cat([values] * basis, dim=-1)
        if cfg.pos_enc == "fourier":
            v = 2.0 * math.pi * tiled * self.fourier_coefficients_pts
            enc = torch.cat([torch.sin(v), torch.cos(v)], dim=-1)
        else:
            k = barf_k_values(basis, values.shape[-1], device=values.device)
            w = barf_weights(alpha, k)
            v = (torch.pow(2.0, k) * math.pi) * tiled
            enc = torch.cat([w * torch.sin(v), w * torch.cos(v)], dim=-1)
        return torch.cat([values, enc], dim=-1)
