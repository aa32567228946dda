"""Evaluation and export CLI (port of ``cli/evaluate.py``): the reference's
``visualization/visualization.py`` flags (visualization.py:47-57:
``--binary``, ``--data_name``) plus run / volume paths and ``--device``.

For each run under ``cases/<data_name>/runs/`` (or ``--run_dir``): restores
the model bundle and occupancy grid, renders the 37x37 sweep, computes the
metrics and writes df-metrics.csv, the PNGs, the field VTK, the videos and
the cag-vis JSONs under ``jsonData/``. ``--no_heatmap_png`` writes the JSONs
without the polar heatmap PNGs, which need matplotlib.

    python -m nerf_for_angiography_tpu_torch.cli.evaluate --data_name ct

Under ``torchrun --nproc_per_node=N`` the sweep's views are sharded over the
N processes and only rank 0 writes.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os

import numpy as np
import torch

from ..convert import cppn_params_from_jax, field_params
from ..evaluation import EvalConfig, PerceptualMetrics, gt_from_volume, lca_eval_config, run_sweep
from ..evaluation.sweep import export_heatmaps
from ..models import CPPN, CPPNConfig
from ..ops.interpolation import trilinear
from ..parallel import is_coordinator
from ..training import load_grid_vtk, load_model
from .common import cli_device, cli_mesh, load_volume


def read_page_data(run_dir: str) -> dict | None:
    """The experiment metadata the trainer recorded (readme.txt, the
    reference's page_data registry), so jsonData uses the experiment
    naming cag-vis expects."""
    readme = os.path.join(run_dir, "readme.txt")
    if not os.path.exists(readme):
        return None
    page_data = {}
    with open(readme) as f:
        for line in f:
            if "=" not in line:
                continue
            k, v = line.strip().split("=", 1)
            try:
                page_data[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                page_data[k] = v
    return page_data


def main(argv=None) -> dict:
    """Evaluate every run found; returns {run_dir: metric column table}."""
    p = argparse.ArgumentParser()
    p.add_argument("--binary", help="Whether images are binary or not")
    p.add_argument("--data_name", default="ct", help="Either CT data or LCA data")
    p.add_argument("--run_dir", default=None, help="specific run directory")
    p.add_argument("--volume", default="phantom:vessel",
                   help="GT volume: VTK path or phantom:vessel / phantom:sphere / phantom:lca")
    p.add_argument("--perceptual_weights", default=None,
                   help=".npz from tools/convert_perceptual_weights.py")
    p.add_argument("--uncalibrated_perceptual", action="store_true", default=True,
                   help="compute LPIPS/DISTS with the fixed-random VGG backend when no "
                        "pretrained weights are given (marked calibrated=false in "
                        "df-metrics.csv and the heatmap JSONs); the default - disable "
                        "with --no_perceptual")
    p.add_argument("--no_perceptual", action="store_true", help="skip LPIPS/DISTS entirely")
    p.add_argument("--number_angles_vis", default=None,
                   help="sweep density (default 36 -> 37x37 views)")
    p.add_argument("--img_size", default=None, help="override image size")
    p.add_argument("--depth_samples", default=None, help="samples per ray")
    p.add_argument("--field_resolution", default=None,
                   help="3D field export lattice (default 201)")
    p.add_argument("--no_videos", action="store_true")
    p.add_argument("--no_heatmap_png", action="store_true",
                   help="write the cag-vis JSONs without the polar heatmap PNGs (which "
                        "need matplotlib)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    binary = a.binary == "True"
    device = cli_device(a.device)

    is_lca = a.data_name.upper() == "LCA"
    kw = {"binary": binary}
    if a.number_angles_vis:
        kw["number_angles_vis"] = float(a.number_angles_vis)
    if a.img_size:
        kw["img_width"] = kw["img_height"] = int(a.img_size)
    if a.depth_samples:
        kw["depth_samples_per_ray"] = int(a.depth_samples)
    if a.field_resolution:
        kw["field_resolution"] = int(a.field_resolution)
    if a.no_videos:
        kw["save_videos"] = False
    cfg = lca_eval_config(**kw) if is_lca else EvalConfig(**kw)
    sweep_cfg = dataclasses.replace(cfg, save_heatmap=False) if a.no_heatmap_png else cfg
    volume = load_volume(a.volume, is_lca, binary, device)
    mesh = cli_mesh()  # under torchrun: the sweep's views sharded over the ranks

    # pretrained weights if given, else the fixed-random uncalibrated VGG
    # (the reference evaluates DISTS/LPIPS by default, visualization.py:38-39;
    # its values are flagged calibrated=false)
    perceptual = None
    if a.perceptual_weights:
        perceptual = PerceptualMetrics.from_npz(a.perceptual_weights, device=device)
    elif a.uncalibrated_perceptual and not a.no_perceptual:
        perceptual = PerceptualMetrics.uncalibrated(device=device)
        print("LPIPS/DISTS: uncalibrated random-VGG backend (no --perceptual_weights); "
              "values flagged calibrated=false")

    if a.run_dir:
        run_dirs = [a.run_dir]
    else:
        root = os.path.join("cases", a.data_name, "runs")
        run_dirs = sorted((os.path.join(root, d) for d in os.listdir(root)), reverse=True)

    tables = {}
    for rd in run_dirs:
        model_path = os.path.join(rd, "highmodel.npz")
        if not os.path.exists(model_path):
            print(f"{rd}: no highmodel.npz, skipping")
            continue
        print(f"evaluating {rd}")
        meta, params = load_model(model_path)
        mdef = meta["parameters"]
        model = CPPN(CPPNConfig(
            num_early_layers=mdef["num_early_layers"],
            num_late_layers=mdef["num_late_layers"],
            num_filters=mdef["num_filters"],
            pos_enc=mdef["pos_enc"],
            pos_enc_basis=mdef["pos_enc_basis"],
            act_func="relu",  # visualization.py:180 forces relu
            input_scale=1.0 / cfg.outside,
            dtype=torch.bfloat16,
        ), device=device)
        model.load_state_dict(field_params(cppn_params_from_jax(params)))
        model.requires_grad_(False)
        aabb = np.array([-cfg.outside] * 3 + [cfg.outside] * 3, np.float32)
        grid = load_grid_vtk(os.path.join(rd, "coarsegrid.vtk"), aabb, device=device)
        page_data = read_page_data(rd)
        table = run_sweep(model, grid, sweep_cfg, gt_from_volume(volume, cfg), rd,
                          page_data=page_data, perceptual=perceptual,
                          gt_volume_sampler=lambda pts: trilinear(volume, pts), device=device,
                          mesh=mesh)
        if a.no_heatmap_png and cfg.save_heatmap and is_coordinator():
            export_heatmaps(table, cfg, rd, page_data, perceptual, save_png=False)
        tables[rd] = table
        print(f"  wrote df-metrics.csv + exports under {rd}")
    return tables


if __name__ == "__main__":
    main()
