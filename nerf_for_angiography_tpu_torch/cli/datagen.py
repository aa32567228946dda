"""Phantom datagen CLI (port of ``cli/datagen.py``): the reference's
``phantomdata/cttoray.py`` / ``sdftoray.py`` flags (cttoray.py:16-32) plus
``--data_name`` / ``--volume`` / ``--out`` / ``--img_size`` / ``--device``.

Renders the C-arm DRR sweep on the device and writes, under
``<out>/ct`` or ``<out>/stl/LCA``: one gray PNG and one weight-map PNG a
view (``projections/image[-transform]-{theta}-{phi}-{larm}.png``),
``ground-truth.vtk``, ``transferfunc{binary}.vtk`` and the two CSVs with the
reference's schemas. ``--volume phantom:vessel`` / ``phantom:sphere`` /
``phantom:lca`` use the built-in analytic phantoms.

    python -m nerf_for_angiography_tpu_torch.cli.datagen --volume phantom:vessel
"""

from __future__ import annotations

import argparse
import ast
import os

from ..data import DatagenConfig, generate_dataset, write_proj_csv, write_rays_csv
from ..data.datasets import sdf_datagen_config
from ..data.volumes import export_ground_truth_vtk, export_transferfunc_vtk
from ..utils.png import write_png_colormap, write_png_unit
from ..parallel import is_coordinator
from .common import cli_device, load_volume


def csv_file_names(cfg: DatagenConfig, is_sdf: bool) -> tuple[str, str]:
    """The two CSVs' file names (cttoray.py:271-308): df-{file_name}-{binary}-
    {ct|sdf}toproj.csv and df-rays-{file_name}-{binary}-{H}.csv."""
    binary_str = "binary" if cfg.binary else ""
    if cfg.number_angles > 0 and cfg.limited_size != 360:
        kind = "limited-sparse" if cfg.binary else "background"
        file_name = f"{kind}-{cfg.limited_size}-{cfg.number_angles}-{list(cfg.center_point)}"
    else:
        file_name = "clinical-angles"
    tag = "sdftoproj" if is_sdf else "cttoproj"
    return (f"df-{file_name}-{binary_str}-{tag}.csv",
            f"df-rays-{file_name}-{binary_str}-{cfg.img_height}.csv")


def main(argv=None) -> dict:
    """Run the datagen; returns the folder and the two CSV paths (None on
    the other ranks of a torchrun launch: rank 0 alone renders and
    writes)."""
    p = argparse.ArgumentParser()
    p.add_argument("--limited_size", help="Angle range to sample the projections in")
    p.add_argument("--number_angles", help="Number of projections to sample per axis")
    p.add_argument("--center_point", help="Center point for the angle sampling")
    p.add_argument("--binary", help="Whether images are binary or not")
    p.add_argument("--sampling_strategy",
                   help="What sampling strategy to use, options: frangi, segmentation or random")
    p.add_argument("--data_name", default="ct", help="ct or LCA")
    p.add_argument("--volume", default="phantom:vessel",
                   help="VTK volume path, or phantom:vessel / phantom:sphere / phantom:lca")
    p.add_argument("--out", default="data", help="output root directory")
    p.add_argument("--img_size", default=None, help="override image size (pixels)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    device = cli_device(a.device)
    if not is_coordinator():  # under torchrun: one process renders and writes
        return None

    is_sdf = a.data_name.upper() == "LCA"
    kw = {}
    if a.limited_size is not None:
        kw["limited_size"] = float(a.limited_size)
    if a.number_angles is not None:
        kw["number_angles"] = float(a.number_angles)
    if a.center_point is not None:
        kw["center_point"] = tuple(ast.literal_eval(a.center_point))
    if a.binary is not None:
        kw["binary"] = a.binary == "True"
    if a.sampling_strategy is not None:
        kw["sampling_strategy"] = a.sampling_strategy
    if a.img_size is not None:
        kw["img_width"] = kw["img_height"] = int(a.img_size)
    cfg = sdf_datagen_config(**kw) if is_sdf else DatagenConfig(**kw)
    volume = load_volume(a.volume, is_sdf, cfg.binary, device)

    folder = os.path.join(a.out, "stl/LCA" if is_sdf else "ct")
    proj_folder = os.path.join(folder, "projections")
    os.makedirs(proj_folder, exist_ok=True)

    print(f"rendering {cfg.limited_size}/{cfg.number_angles} sweep on {device}...")
    ds = generate_dataset(volume, cfg, device=device)
    larm = cfg.larm
    for (theta, phi), img, wmap in zip(ds.angles, ds.images, ds.weight_maps):
        write_png_unit(f"{proj_folder}/image-{theta}-{phi}-{larm}.png", img)
        write_png_colormap(f"{proj_folder}/image-transform-{theta}-{phi}-{larm}.png", wmap)

    export_ground_truth_vtk(volume, os.path.join(folder, "ground-truth.vtk"))
    binary_str = "binary" if cfg.binary else ""
    # transfer-function side artifact (helpers.py:122-126); 'binary' suffix
    # and VTK binary mode for the binary transfer variant
    export_transferfunc_vtk(volume, os.path.join(folder, f"transferfunc{binary_str}.vtk"),
                            binary=cfg.binary)
    proj_name, rays_name = csv_file_names(cfg, is_sdf)
    proj_csv, rays_csv = os.path.join(folder, proj_name), os.path.join(folder, rays_name)
    write_proj_csv(ds, proj_csv)
    write_rays_csv(ds, rays_csv)
    print(f"wrote {len(ds.angles)} views to {folder}")
    return dict(folder=folder, proj_csv=proj_csv, rays_csv=rays_csv)


if __name__ == "__main__":
    main()
