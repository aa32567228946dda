from .datasets import DatagenConfig, GeneratedDataset, angle_grid, generate_dataset
from .drr import render_drr, render_view
from .phantoms import make_sphere_volume, make_vessel_volume
from .weights import frangi, get_weighted_img

__all__ = [
    "DatagenConfig",
    "GeneratedDataset",
    "angle_grid",
    "frangi",
    "generate_dataset",
    "get_weighted_img",
    "make_sphere_volume",
    "make_vessel_volume",
    "render_drr",
    "render_view",
]
