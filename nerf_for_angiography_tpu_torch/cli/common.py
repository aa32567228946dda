"""What the entry points share: the device, the mesh of a run under
``torchrun``, and the volume a name selects."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..data import make_lca_sdf_volume, make_sphere_volume, make_vessel_volume
from ..data.volumes import load_ct_volume, load_sdf_volume
from ..device import resolve_device
from ..ops.interpolation import RegularGrid
from ..parallel import create_mesh, initialize_multihost


def cli_device(name: str) -> torch.device:
    """The run's device. Under ``torchrun`` (``WORLD_SIZE`` > 1) this
    process joins the process group (NCCL on the card, gloo on the CPU) and
    takes the card ``LOCAL_RANK``; a single process takes the current
    card (the first, unless CUDA_VISIBLE_DEVICES says otherwise)."""
    dev = resolve_device(name)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if not dist.is_initialized():
            initialize_multihost(device=dev.type)
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def cli_mesh():
    """A mesh over every rank when the process group holds more than one
    (``cli_device`` joined it under torchrun), else None."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return create_mesh()
    return None


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
