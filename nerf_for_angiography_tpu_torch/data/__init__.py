from .datasets import (
    DatagenConfig,
    GeneratedDataset,
    LoadedData,
    angle_grid,
    generate_dataset,
    load_data,
    write_proj_csv,
    write_rays_csv,
)
from .drr import render_drr, render_view, render_views_sharded
from .phantoms import (
    make_lca_sdf_volume,
    make_sphere_volume,
    make_vessel_volume,
    sphere_line_integral,
)
from .transfer import rev_sigmoid, transfer_func_ct
from .weights import frangi, get_weighted_img

__all__ = [
    "DatagenConfig",
    "GeneratedDataset",
    "LoadedData",
    "angle_grid",
    "frangi",
    "generate_dataset",
    "get_weighted_img",
    "load_data",
    "make_lca_sdf_volume",
    "make_sphere_volume",
    "make_vessel_volume",
    "render_drr",
    "render_view",
    "render_views_sharded",
    "rev_sigmoid",
    "sphere_line_integral",
    "transfer_func_ct",
    "write_proj_csv",
    "write_rays_csv",
]
