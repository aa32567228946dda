"""Carry CPPN weights from the JAX package's flax params to the port.

The input is the flax params pytree converted to numpy (``jax.tree.map(
np.asarray, params)``), so this module needs neither JAX nor flax. Flax
``Dense`` stores ``kernel`` as (in, out); ``nn.Linear`` stores ``weight``
as (out, in).
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
