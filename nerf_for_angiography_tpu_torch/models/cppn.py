"""CPPN coordinate field as a torch ``nn.Module`` (port of
``nerf_for_angiography_tpu/models/cppn.py``).

The whole module: the early block, the skip connection and late layers
(``num_late_layers``), the activations relu, sine (SIREN, ``sine_w0`` on the
first layer) and tanh, ``use_bias``, the view branch
(``num_input_channels_views > 0``: alpha and rgb heads, the views through
their own encoding at ``barf_alpha_views``), and ``pos_enc`` 'none',
'fourier' (learnable Gaussian coefficients) or 'barf' (fixed 2^k pi
frequencies under a coarse-to-fine window that is a pure function of the
alpha; ref CPPN.py:52-135,166-259). Parameter names follow the flax module
(``input_layer``, ``early_i``, ``skip_connection``, ``late_i``,
``alpha_linear``, ``feature_linear``, ``views_layer``, ``rgb_linear``,
``output_linear``, ``fourier_coefficients_pts`` / ``_views``, ``img1``,
``img2``) so weights carry across one to one (``convert.py``).
Initialisation matches flax in distribution (lecun_normal kernels — a
truncated normal of variance 1/fan_in — zero biases, N(0, fourier_sigma^2)
coefficients), not in bits.
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

    @property
    def encoded_views_features(self) -> int:
        c = self.num_input_channels_views
        if self.pos_enc != "none" and self.pos_enc_basis_views > 0:
            return c + c * 2 * self.pos_enc_basis_views
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


def sine(w0: float = 1.0):
    """SIREN activation act(x) = sin(w0 * x). Ref: CPPN.py:278-294."""

    def act(x):
        return torch.sin(w0 * x)

    return act


def _activation(name: str, first: bool, w0: float):
    if name == "sine":
        return sine(w0 if first else 1.0)
    if name == "tanh":
        return torch.tanh
    return torch.relu


def _dense(lin: nn.Linear, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax Dense with ``dtype``: input, kernel and bias cast to the compute
    dtype, the result in it."""
    bias = None if lin.bias is None else lin.bias.to(dt)
    return nn.functional.linear(h.to(dt), lin.weight.to(dt), bias)


class CPPN(nn.Module):
    """Coordinate MLP: (x, y, z)[+ view direction] -> 1-channel raw density,
    or [rgb, alpha] with the view branch; the coordinates (and views)
    optionally through the fourier or BARF positional encoding."""

    def __init__(self, config: CPPNConfig, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        if config.pos_enc not in ("none", "fourier", "barf"):
            raise ValueError(f"unknown pos_enc: {config.pos_enc!r}")
        self.config = config
        f = config.num_filters
        kw = dict(device=device, dtype=torch.float32)
        bias = config.use_bias
        self.input_layer = nn.Linear(config.encoded_pts_features, f, bias=bias, **kw)
        for i in range(config.num_early_layers):
            setattr(self, f"early_{i}", nn.Linear(f, f, bias=bias, **kw))
        if config.num_late_layers > 0:
            self.skip_connection = nn.Linear(config.encoded_pts_features + f, f, bias=bias, **kw)
            for i in range(config.num_late_layers - 1):
                setattr(self, f"late_{i}", nn.Linear(f, f, bias=bias, **kw))
        if config.use_viewdirs:
            n_out = config.num_output_channels - 1
            self.alpha_linear = nn.Linear(f, n_out, bias=bias, **kw)
            # flax's feature_linear is a Dense without use_bias: always biased
            self.feature_linear = nn.Linear(f, f, **kw)
            self.views_layer = nn.Linear(f + config.encoded_views_features, f // 2, bias=bias,
                                         **kw)
            self.rgb_linear = nn.Linear(f // 2, n_out, bias=bias, **kw)
        else:
            self.output_linear = nn.Linear(f, config.num_output_channels, bias=bias, **kw)
        # per-image learnable translations, parity with CPPN.py:133-135
        self.img1 = nn.Parameter(torch.zeros(2, **kw))
        self.img2 = nn.Parameter(torch.zeros(2, **kw))
        for lin in self.modules():
            if isinstance(lin, nn.Linear):
                lecun_normal_(lin.weight, generator)
                if lin.bias is not None:
                    nn.init.zeros_(lin.bias)
        if config.pos_enc == "fourier":
            # learnable Gaussian coefficients ~ N(0, sigma^2) (CPPN.py:70-80)
            for kind, c, basis in (("pts", config.num_input_channels, config.pos_enc_basis),
                                   ("views", config.num_input_channels_views,
                                    config.pos_enc_basis_views)):
                if basis > 0 and (kind == "pts" or config.use_viewdirs):
                    coeff = torch.randn((c * basis,), generator=generator, dtype=torch.float32)
                    setattr(self, f"fourier_coefficients_{kind}",
                            nn.Parameter((coeff * config.fourier_sigma).to(device)))

    def linears(self) -> list[nn.Linear]:
        """The density stack in kernel order: input_layer, early_i and
        output_linear (the layers of a model the fused kernels take)."""
        n = self.config.num_early_layers
        return (
            [self.input_layer]
            + [getattr(self, f"early_{i}") for i in range(n)]
            + [self.output_linear]
        )

    def add_view_shifts(self, num_views: int) -> None:
        """Register the pose-refinement parameter ``view_shifts``, a (V, 3)
        f32 world translation per view, zero at the start (the JAX package
        keeps it in the params collection under the same name)."""
        ref = self.img1
        self.view_shifts = nn.Parameter(
            torch.zeros((num_views, 3), dtype=torch.float32, device=ref.device))

    def forward(self, x: torch.Tensor, barf_alpha=0.0, barf_alpha_views=0.0) -> torch.Tensor:
        """x (..., num_input_channels + num_input_channels_views) -> (...,
        num_output_channels) float32: the coordinates scaled by
        ``input_scale``, the encodings in f32, then every layer in the
        compute dtype of the config (flax Dense with ``dtype``: inputs,
        weights and biases cast, result rounded to that dtype per layer).
        ``barf_alpha`` / ``barf_alpha_views`` set the BARF windows."""
        cfg = self.config
        dt = cfg.dtype
        n_in = cfg.num_input_channels + cfg.num_input_channels_views
        if x.shape[-1] != n_in:
            raise ValueError(
                f"the CPPN takes {cfg.num_input_channels} coordinate + "
                f"{cfg.num_input_channels_views} view channels, got x of width {x.shape[-1]}")
        act = _activation(cfg.act_func, False, cfg.sine_w0)
        first_act = _activation(cfg.act_func, True, cfg.sine_w0)
        pts = x[..., : cfg.num_input_channels] * cfg.input_scale
        pts_encoded = self._pos_enc(pts, cfg.pos_enc_basis, "pts", barf_alpha)
        h = first_act(_dense(self.input_layer, pts_encoded, dt))
        for i in range(cfg.num_early_layers):
            h = act(_dense(getattr(self, f"early_{i}"), h, dt))
        if cfg.num_late_layers > 0:
            h = act(_dense(self.skip_connection, torch.cat([pts_encoded, h.float()], -1), dt))
            for i in range(cfg.num_late_layers - 1):
                h = act(_dense(getattr(self, f"late_{i}"), h, dt))
        if cfg.use_viewdirs:
            views_encoded = self._pos_enc(x[..., cfg.num_input_channels:],
                                          cfg.pos_enc_basis_views, "views", barf_alpha_views)
            alpha_out = _dense(self.alpha_linear, h, dt)
            feature = _dense(self.feature_linear, h, dt)
            v = act(_dense(self.views_layer, torch.cat([feature.float(), views_encoded], -1), dt))
            rgb = _dense(self.rgb_linear, v, dt)
            out = torch.cat([rgb, alpha_out], dim=-1)
        else:
            out = _dense(self.output_linear, h, dt)
        return out.to(torch.float32)

    def _pos_enc(self, values: torch.Tensor, basis: int, kind: str, alpha) -> torch.Tensor:
        """concat([x, enc(tile(x, L))]) in f32, as flax's _pos_enc (ref
        CPPN.py:207-234): feature order [x, sin rows, cos rows], row j
        encoding channel j % C at band j // C."""
        cfg = self.config
        if cfg.pos_enc == "none" or basis <= 0:
            return values
        tiled = torch.cat([values] * basis, dim=-1)
        if cfg.pos_enc == "fourier":
            v = 2.0 * math.pi * tiled * getattr(self, f"fourier_coefficients_{kind}")
            enc = torch.cat([torch.sin(v), torch.cos(v)], dim=-1)
        else:
            k = barf_k_values(basis, values.shape[-1], device=values.device)
            w = barf_weights(alpha, k)
            v = (torch.pow(2.0, k) * math.pi) * tiled
            enc = torch.cat([w * torch.sin(v), w * torch.cos(v)], dim=-1)
        return torch.cat([values, enc], dim=-1)
