"""numpy-only helpers: the legacy-VTK reader/writer and a grayscale PNG
writer."""

from .png import read_png_gray, write_png_gray
from .vtk import (
    VtkGrid,
    flat_vtk_order,
    read_vtk,
    write_structured_grid,
    write_structured_points,
)

__all__ = [
    "VtkGrid",
    "flat_vtk_order",
    "read_png_gray",
    "read_vtk",
    "write_png_gray",
    "write_structured_grid",
    "write_structured_points",
]
