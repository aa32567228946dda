"""Checkpointing (port of ``nerf_for_angiography_tpu/training/checkpoint.py``):
resume state and the reference-compatible artifacts.

* ``save_model`` / ``load_model`` write and read the JAX package's model
  bundle: one ``np.savez`` with a ``__meta__`` JSON ({version, parameters,
  training_information, param_keys}) and the parameters under their
  ``/``-joined flax names (``params/input_layer/kernel``, kernels as (in,
  out)). A bundle either package writes, the other reads.
* ``save_grid_vtk`` / ``load_grid_vtk``: binary occupancy as int CELL_DATA
  on a (res+1)^3-point uniform grid (run_nerf_acc.py:200-204,359-367).
* ``CheckpointManager``: the whole ``TrainState`` for resume, written with
  ``torch.save`` (the JAX package uses orbax): the module's, optimizer's and
  scheduler's ``state_dict``, both grids, the step and the generator's
  state, one file a step, written to a temporary name and renamed.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from ..convert import cppn_params_to_jax
from ..ops.occupancy import OccupancyGrid, grid_from_numpy
from ..utils.vtk import read_vtk, write_structured_points

MODEL_VERSION = "v0.10-tpu"  # the JAX package's bundle version: one format


# --- reference-style model bundles (highmodel / coarsemodel) ---------------


def _flatten(params, prefix=""):
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}" if not prefix else f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat):
    out = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def save_model(path: str, model_definition: dict, model: torch.nn.Module,
               training_information: dict | None = None) -> None:
    """CPPN.save equivalent (model/CPPN.py:261-276): the port CPPN's
    parameters stored under their flax names."""
    flat = _flatten(cppn_params_to_jax(model.state_dict()))
    meta = {
        "version": MODEL_VERSION,
        "parameters": model_definition,
        "training_information": training_information or {},
        "param_keys": list(flat.keys()),
    }
    np.savez(path, __meta__=json.dumps(meta), **flat)


def load_model(path: str) -> tuple[dict, Any]:
    """(meta dict, flax-named numpy params); ``convert.cppn_params_from_jax``
    turns the params into the port CPPN's ``state_dict``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in meta["param_keys"]}
    return meta, _unflatten(flat)


# --- occupancy grid VTK export/restore --------------------------------------


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_grid_vtk(path: str, grid: OccupancyGrid) -> None:
    """coarsegrid.vtk-style export: binary occupancy as int CELL_DATA on a
    (res+1)^3-point uniform grid. ``grid`` may hold tensors or numpy
    arrays (the loop's host snapshot)."""
    aabb = _host(grid.aabb)
    write_structured_points(
        path,
        _host(grid.binary).astype(np.int32),
        origin=tuple(aabb[:3]),
        spacing=tuple((aabb[3:] - aabb[:3]) / grid.resolution),
        name="values",
        cell=True,
        binary=True,  # 128^3 cells; ASCII is ~100x slower to write
    )


def load_grid_vtk(path: str, aabb, device=None) -> OccupancyGrid:
    """Restore a binary occupancy grid from VTK (visualization.py:158-162):
    occs = binary as f32, as the JAX package restores it, and the coarse
    table rebuilt."""
    binary = read_vtk(path).scalars_3d("values", cell=True).astype(bool)
    return grid_from_numpy(binary, _host(aabb), occs=binary.astype(np.float32), device=device)


# --- resume state ------------------------------------------------------------


_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Periodic full-state checkpointing for resume-on-preemption: the
    newest ``max_to_keep`` steps are kept, one ``ckpt_<step>.pt`` each."""

    def __init__(self, directory: str, max_to_keep: int = 2, create: bool = True):
        """``create=False``: a reader that makes no directory (a sharded
        run's other ranks, which resume but never save)."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if create:
            os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _CKPT.match(f)))

    def save(self, step: int, state) -> None:
        """Write ``state`` (a ``TrainState``) as step ``step``, then drop
        all but the newest ``max_to_keep``."""
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "grid": state.grid._asdict(),
            "vessel_grid": state.vessel_grid._asdict(),
            "step": int(state.step),
            "generator": state.generator.get_state(),
        }
        path = self._path(step)
        tmp = f"{path}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like):
        """Load the newest checkpoint into ``state_like`` (a ``TrainState``
        of the same configuration, whose tensors' device it keeps) and
        return it; None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        device = state_like.grid.occs.device
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        state_like.model.load_state_dict(payload["model"])
        state_like.optimizer.load_state_dict(payload["optimizer"])
        state_like.scheduler.load_state_dict(payload["scheduler"])
        state_like.grid = OccupancyGrid(**payload["grid"])
        state_like.vessel_grid = OccupancyGrid(**payload["vessel_grid"])
        state_like.step = payload["step"]
        state_like.generator.set_state(payload["generator"].cpu())
        return state_like

    def close(self) -> None:
        """Nothing is left open: every save is complete when it returns."""
