"""Carry weights between the JAX package and the port: the CPPN's flax params
and the perceptual metrics' VGG / LPIPS / DISTS weights.

The flax side is the params pytree as numpy (``jax.tree.map(np.asarray,
params)``, ``{"params": {layer: {"kernel", "bias"}, name: array}}``), so
this module needs neither JAX nor flax. Flax ``Dense`` stores ``kernel`` as
(in, out); ``nn.Linear`` stores ``weight`` as (out, in).
"""

from __future__ import annotations

import numpy as np
import torch


def cppn_params_from_jax(flax_params_as_numpy: dict) -> dict[str, torch.Tensor]:
    """flax CPPN params (as numpy) -> the port CPPN's ``state_dict``."""
    p = flax_params_as_numpy.get("params", flax_params_as_numpy)
    out: dict[str, torch.Tensor] = {}
    for name, leaf in p.items():
        if isinstance(leaf, dict):
            out[f"{name}.weight"] = torch.from_numpy(np.array(leaf["kernel"], np.float32).T.copy())
            out[f"{name}.bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))
        else:
            out[name] = torch.from_numpy(np.array(leaf, np.float32))
    return out


def cppn_params_to_jax(state_dict) -> dict:
    """The port CPPN's ``state_dict`` -> flax-named params as numpy f32,
    ``{"params": ...}`` as the JAX TrainState holds them (the inverse of
    ``cppn_params_from_jax``)."""
    p: dict = {}
    for name, t in state_dict.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        layer, _, leaf = name.rpartition(".")
        if leaf == "weight":
            p.setdefault(layer, {})["kernel"] = np.ascontiguousarray(a.T)
        elif leaf == "bias":
            p.setdefault(layer, {})["bias"] = a.copy()
        else:
            p[name] = a.copy()
    return {"params": p}


def perceptual_params_from_jax(vgg_params, lpips_weights, dists_alpha, dists_beta) -> dict:
    """The JAX ``PerceptualMetrics`` weights (as numpy: VGG convs (w HWIO,
    b), the LPIPS and DISTS per-stage lists) -> the keyword arguments of the
    port's ``PerceptualMetrics`` but ``calibrated``: convs as OIHW f32
    tensors."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    return dict(
        vgg_params=[(t(np.asarray(w).transpose(3, 2, 0, 1)), t(b)) for w, b in vgg_params],
        lpips_weights=[t(w) for w in lpips_weights],
        dists_alpha=[t(a) for a in dists_alpha],
        dists_beta=[t(b) for b in dists_beta],
    )
