"""What the entry points share: the device, and the volume a name selects."""

from __future__ import annotations

import torch

from ..data import make_lca_sdf_volume, make_sphere_volume, make_vessel_volume
from ..data.volumes import load_ct_volume, load_sdf_volume
from ..device import resolve_device
from ..ops.interpolation import RegularGrid


def cli_device(name: str) -> torch.device:
    """The run's device; on a host with several cards the run takes the
    first (the JAX CLIs shard over a mesh there)."""
    dev = resolve_device(name)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"{torch.cuda.device_count()} cards: running on cuda:0; DDP across cards "
              "arrives with ROADMAP Queue 1 item 5")
        dev = torch.device("cuda:0")
    return dev


def load_volume(name: str, sdf: bool, binary: bool, device: torch.device) -> RegularGrid:
    """phantom:vessel / phantom:sphere / phantom:lca, or a VTK file read as
    an SDF (LCA) or CT volume."""
    if name == "phantom:vessel":
        return make_vessel_volume(device=device)
    if name == "phantom:sphere":
        return make_sphere_volume(device=device)
    if name == "phantom:lca":
        return make_lca_sdf_volume(device=device)
    if sdf:
        return load_sdf_volume(name, device=device)
    return load_ct_volume(name, binary=binary, device=device)
