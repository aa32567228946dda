"""Polar heatmap and JSON export for the cag-vis web tool (a numpy copy of
``nerf_for_angiography_tpu/evaluation/heatmap.py``, which the port does not
import).

Reproduces visualization/helpers.py:72-259 (get_spherical_coordinates,
convert_to_polar, get_2d_heatmap): hemisphere filtering by axis pair,
camera-pose -> polar conversion, a matplotlib polar pcolormesh PNG, and the
two JSON products the web app reads (ReactHeatmap.js:79-118,245-363):
  * ``{metric}-{top|bottom}-{X}-{Z}.json``: {rad, theta, angles, vals}
    sorted by descending radius;
  * one ``{theta}{phi}.json`` per angle: {pred, org, diff} flat image arrays.

The sweep's results are a column table: a dict from column name to a numpy
array with one row a view (``pred_img`` / ``org_img`` as (N, H*W) arrays).
The JSONs are written by the native writer (``native/json_export.cpp``, as
the JAX package writes them), whose floats are the shortest round-trip form,
so ``json.load`` gives the values ``json.dumps`` would have written; a
heatmap JSON that carries extra keys (``json_extra``) is written with
``json``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..native import write_angle_json, write_heatmap_json


def get_spherical_coordinates(thetas, phis):
    """Unit-sphere coordinates for angle grids. Ref: helpers.py:72-93."""
    coords, angles = [], []
    for theta in thetas:
        for phi in phis:
            tr, pr = np.deg2rad(theta), np.deg2rad(phi)
            coords.append(
                [np.sin(tr) * np.cos(pr), np.sin(tr) * np.sin(pr), np.cos(tr)]
            )
            angles.append([theta, phi])
    coords = np.array(coords)
    angles = np.array(angles)
    return {
        "X": coords[:, 0], "Y": coords[:, 1], "Z": coords[:, 2],
        "theta": angles[:, 0], "phi": angles[:, 1],
    }


def convert_to_polar(x, y):
    """Ref: helpers.py:95-98 (2-decimal rounding is load-bearing: the grid
    matching downstream groups by these rounded values)."""
    theta = np.round(np.arctan2(y, x), decimals=2)
    rad = np.round(np.sqrt(np.asarray(x) ** 2 + np.asarray(y) ** 2), decimals=2)
    return theta, rad


def hemisphere_mask(theta, phi, x_axis: str, y_axis: str, name: str):
    """Hemisphere filters per axis pair (helpers.py:106-120)."""
    theta = np.asarray(theta)
    phi = np.asarray(phi)
    pair = {x_axis, y_axis}
    if pair == {"X", "Y"}:
        if name == "top":
            return (theta <= 90) & (theta >= -90) & (phi <= 90) & (phi >= -90)
        return ((theta >= 90) | (theta <= -90)) & ((phi >= 90) | (phi <= -90))
    if pair == {"X", "Z"}:
        if name == "top":
            return (theta >= 0) & (theta <= 180) & (phi <= 90) & (phi >= -90)
        return (theta <= 0) & (theta >= -180) & (phi <= 90) & (phi >= -90)
    if pair == {"Y", "Z"}:
        if name == "top":
            return (theta <= 90) & (theta >= -90) & (phi >= 0) & (phi <= 180)
        return (theta <= 90) & (theta >= -90) & (phi <= 0) & (phi >= -180)
    raise ValueError(f"unsupported axes {x_axis}-{y_axis}")


def normalize_cam_poses(table: dict) -> None:
    """In-place [-1,1] min-max normalisation of cam_pose_{x,y,z}
    (visualization.py:581-583)."""
    for c in ("cam_pose_x", "cam_pose_y", "cam_pose_z"):
        v = np.asarray(table[c], float)
        rng = v.max() - v.min()
        table[c] = ((v - v.min()) / rng) * 2 - 1 if rng > 0 else np.zeros_like(v)


def get_2d_heatmap(
    table: dict,
    store_folder_name: str,
    experiment_folder: str,
    name: str = "top",
    x_axis: str = "X",
    y_axis: str = "Z",
    metric: str = "PSNR",
    vminmax=(0.0, 1.0),
    center_point=(0, 0),
    save_json: bool = True,
    save_png: bool = True,
    json_extra: dict | None = None,
) -> dict | None:
    """One hemisphere heatmap: a PNG for humans and the JSONs for cag-vis.

    ``table`` must carry theta/phi, normalised cam poses, the metric column
    and pred_img/org_img rows (as the sweep produces). Returns the JSON
    object (or None if the hemisphere is empty or ``save_json`` is off)."""
    return _get_2d_heatmap(table, store_folder_name, experiment_folder, name, x_axis, y_axis,
                           metric, vminmax, center_point, save_json, save_png, json_extra)


def _get_2d_heatmap(table, store_folder_name, experiment_folder, name, x_axis, y_axis, metric,
                    vminmax, center_point, save_json, save_png, json_extra,
                    angles_written: set | None = None):
    """get_2d_heatmap; with ``angles_written``, a per-angle file whose name
    is in the set is not written again (its content is the same for every
    metric and hemisphere), and each name written is added."""
    sel = hemisphere_mask(table["theta"], table["phi"], x_axis, y_axis, name)
    rows = np.flatnonzero(sel)
    if len(rows) == 0:
        return None
    theta_s = np.asarray(table["theta"], float)[rows]
    phi_s = np.asarray(table["phi"], float)[rows]

    thetas_u = list(dict.fromkeys(theta_s.tolist()))
    phis_u = list(dict.fromkeys(phi_s.tolist()))

    theta_pol, rad_pol = convert_to_polar(
        np.asarray(table[f"cam_pose_{x_axis.lower()}"], float)[rows],
        np.asarray(table[f"cam_pose_{y_axis.lower()}"], float)[rows] + 1e-10,
    )

    n_phi, n_theta = len(phis_u), len(thetas_u)
    if n_phi * n_theta != len(rows):
        # irregular hemisphere (shouldn't happen with full sweeps)
        n_phi, n_theta = len(rows), 1

    theta_r = theta_pol.reshape(n_phi, n_theta)
    rad_r = rad_pol.reshape(n_phi, n_theta)
    vals = np.asarray(table[metric], float)[rows].reshape(n_phi, n_theta)
    ang = np.stack([theta_s, phi_s], -1).reshape(n_phi, n_theta, 2)

    # plot grid: drop pure-pole rows and the wrap column (helpers.py:143-177)
    keep_rows = [
        i for i in range(n_phi) if not np.array_equal(np.unique(rad_r[i]), [0.0])
    ]
    vals_plot = vals[keep_rows][:, :-1] if n_theta > 1 else vals[keep_rows]

    if save_png and vals_plot.shape == (n_phi - 1, n_theta - 1):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(30, 30))
        plt.subplot(projection="polar")
        plt.pcolormesh(
            theta_r, rad_r, vals_plot, vmin=vminmax[0], vmax=vminmax[1], alpha=0.9
        )
        at_center = np.flatnonzero((theta_s == center_point[0]) & (phi_s == center_point[1]))
        if len(at_center) > 0:
            pos = at_center[0]
            plt.scatter(theta_pol[pos], rad_pol[pos], c="black", s=100)
        vstr = f"-{np.round(vminmax, decimals=2)}" if len(vminmax) == 2 else "-"
        plt.savefig(
            f"{store_folder_name}/heatmap-{metric}-{name}{vstr}-{x_axis}-{y_axis}.png"
        )
        plt.close()

    if not save_json:
        return None

    # JSON: full grid sorted by descending radius (helpers.py:228-259)
    flat_rad = rad_r.reshape(-1)
    order = np.argsort(flat_rad)[::-1]
    json_obj = {
        "rad": flat_rad[order].tolist(),
        "theta": theta_r.reshape(-1)[order].tolist(),
        "angles": ang.reshape(-1, 2)[order].tolist(),
        "vals": vals.reshape(-1)[order].tolist(),
    }
    os.makedirs(experiment_folder, exist_ok=True)
    metric_path = os.path.join(experiment_folder, f"{metric}-{name}-{x_axis}-{y_axis}.json")
    if json_extra:
        json_obj.update(json_extra)
        with open(metric_path, "w") as f:
            f.write(json.dumps(json_obj))
    else:
        write_heatmap_json(metric_path, json_obj["rad"], json_obj["theta"], json_obj["angles"],
                           json_obj["vals"])

    # per-angle image JSONs ({theta}{phi}.json, helpers.py:255-259)
    preds = table["pred_img"]
    orgs = table["org_img"]
    flat_ang = ang.reshape(-1, 2)
    for k in order:
        t, p = flat_ang[k]
        # canonical one-decimal naming, matched by buildAngleUrl's
        # toFixed(1) (cag_vis/app.js); the reference's f"{t}{p}.json"
        # (helpers.py:256) leans on Python float repr, which a JS number
        # can't reproduce (180.0 -> "180")
        fname = f"{t:.1f}{p:.1f}.json"
        if angles_written is not None:
            if fname in angles_written:
                continue
            angles_written.add(fname)
        pred = np.asarray(preds[rows[k]], float)
        org = np.asarray(orgs[rows[k]], float)
        write_angle_json(os.path.join(experiment_folder, fname), pred, org, np.abs(pred - org))
    return json_obj


def experiment_naming(page_data: dict, center_point=(90, 0)) -> tuple[str, str]:
    """Experiment-folder naming scheme consumed by cag-vis
    (visualization.py:594-657 / ReactHeatmap.js:79-118)."""
    categories = page_data.get("Category", [])
    sampling = page_data.get("Sampling", [])
    arch = page_data.get("Model architecture", "4x128")
    gt_nmb = int(np.sqrt(page_data.get("Sparse projections", 25)) - 1)
    gt_limited = int(page_data.get("Limited projections", 180))
    # integral centerpoints format as ints: the web app's option values are
    # '[90, 0]' (Options.js centerPoint radio), not '[90.0, 0.0]'
    cp = [int(c) if float(c).is_integer() else float(c) for c in center_point]
    name = f"{gt_limited}-{gt_nmb}-{cp}"

    if "Limited projections" in categories and "Sparse projections" in categories:
        experiment = "limited-sparse"
    elif categories == ["Background"]:
        experiment = "background"
        if "Random sampling" in sampling:
            experiment += "-random"
        elif "Segmentation sampling" in sampling:
            experiment += "-segmentation"
    elif categories == ["Sparsity"]:
        experiment = "sparsity"
        if "Random sampling" in sampling:
            experiment += "-random"
        elif "Segmentation sampling" in sampling:
            experiment += "-segmentation"
    else:
        experiment = f"architecture-{arch}"

    data = page_data.get("Data", "CT")
    experiment += "-lca" if "LCA" in data else "-ct"
    return experiment, name
