"""High-level user API: a trained reconstruction you can render and query
(port of ``nerf_for_angiography_tpu/reconstruction.py``).

Load a run directory written by ``train(log_dir=...)`` of either package
(the model bundles and grid VTKs are one format) and render novel views or
query the 3D attenuation field, on the card unless ``device="cpu"``:

    rec = Reconstruction.from_run_dir("cases/ct/runs/2026-.../")
    img = rec.render_view(theta=30, phi=45)          # (H, W) in [0, 1]
    field = rec.density_field(resolution=101)        # (101, 101, 101)
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .convert import cppn_params_from_jax, field_params
from .device import resolve_device
from .evaluation.sweep import EvalConfig, lca_eval_config, make_view_renderer
from .models import CPPN, CPPNConfig
from .ops.occupancy import OccupancyGrid
from .training.checkpoint import load_grid_vtk, load_model
from .training.train import density_raw


@dataclasses.dataclass
class Reconstruction:
    model: CPPN  # holds the parameters
    grid: OccupancyGrid
    eval_config: EvalConfig
    meta: dict

    _renderer: object = None

    @classmethod
    def from_run_dir(
        cls,
        run_dir: str,
        data_name: str = "ct",
        which: str = "high",  # 'high' (best) | 'coarse' (latest periodic)
        eval_config: EvalConfig | None = None,
        device="cuda",
    ) -> "Reconstruction":
        """Load a training run's best (or latest) model and occupancy grid
        (the artifacts visualization.py:158-186 restores) onto ``device``."""
        dev = resolve_device(device)
        if eval_config is None:
            eval_config = (
                lca_eval_config() if data_name.upper() == "LCA" else EvalConfig()
            )
        meta, params = load_model(os.path.join(run_dir, f"{which}model.npz"))
        mdef = meta["parameters"]
        mcfg = CPPNConfig(
            num_early_layers=mdef["num_early_layers"],
            num_late_layers=mdef["num_late_layers"],
            num_filters=mdef["num_filters"],
            pos_enc=mdef["pos_enc"],
            pos_enc_basis=mdef["pos_enc_basis"],
            act_func=mdef.get("act_func", "relu"),
            input_scale=1.0 / eval_config.outside,
            dtype=torch.bfloat16,
        )
        model = CPPN(mcfg, device=dev)
        model.load_state_dict(field_params(cppn_params_from_jax(params)))
        model.requires_grad_(False)
        aabb = np.array(
            [-eval_config.outside] * 3 + [eval_config.outside] * 3, np.float32
        )
        grid_name = "highgrid.vtk" if which == "high" else "coarsegrid.vtk"
        grid = load_grid_vtk(os.path.join(run_dir, grid_name), aabb, device=dev)
        return cls(model=model, grid=grid, eval_config=eval_config, meta=meta)

    @property
    def device(self) -> torch.device:
        return self.grid.occs.device

    def _get_renderer(self):
        if self._renderer is None:
            self._renderer = make_view_renderer(self.model, self.grid, self.eval_config)
        return self._renderer

    def render_view(self, theta: float, phi: float, binary: bool = False) -> np.ndarray:
        """Render the reconstruction from a C-arm angle pair. Angles use the
        evaluation convention (negatives wrap to 360, visualization.py:280-281)."""
        theta = theta if theta >= 0 else 360 + theta
        phi = phi if phi >= 0 else 360 + phi
        cfg = self.eval_config
        pixels, bpixels, _ = self._get_renderer()(self.grid, theta, phi)
        out = bpixels if binary else pixels
        return out.cpu().numpy().reshape(cfg.img_height, cfg.img_width)

    @torch.no_grad()
    def density(self, points) -> np.ndarray:
        """Attenuation field at world points (..., 3)."""
        pts = torch.as_tensor(np.asarray(points, np.float32), device=self.device)
        return torch.sigmoid(density_raw(self.model, pts)).cpu().numpy()

    @torch.no_grad()
    def density_field(self, resolution: int = 101, chunk: int = 262144) -> np.ndarray:
        """Dense (res, res, res) field over the scene AABB ('ij' indexing;
        the sweep's field export uses the reference's 'xy')."""
        e = self.eval_config.outside
        t = np.linspace(-e, e, resolution, dtype=np.float32)
        gx, gy, gz = np.meshgrid(t, t, t, indexing="ij")
        pts = torch.from_numpy(np.stack([gx, gy, gz], -1).reshape(-1, 3)).to(self.device)
        out = np.empty(pts.shape[0], np.float32)
        for s in range(0, pts.shape[0], chunk):
            out[s:s + chunk] = torch.sigmoid(
                density_raw(self.model, pts[s:s + chunk])).cpu().numpy()
        return out.reshape(resolution, resolution, resolution)
