"""numpy-only helpers: the legacy-VTK reader/writer, grayscale and RGBA PNG
writers, and ``;``-separated CSV column tables."""

from .csvtable import read_csv_table, write_csv_table
from .png import (
    colormap_rgba,
    read_png_gray,
    read_png_rgba,
    write_png_colormap,
    write_png_gray,
    write_png_rgba,
    write_png_unit,
)
from .vtk import (
    VtkGrid,
    flat_vtk_order,
    read_vtk,
    write_structured_grid,
    write_structured_points,
)

__all__ = [
    "VtkGrid",
    "colormap_rgba",
    "flat_vtk_order",
    "read_csv_table",
    "read_png_gray",
    "read_png_rgba",
    "read_vtk",
    "write_csv_table",
    "write_png_colormap",
    "write_png_gray",
    "write_png_rgba",
    "write_png_unit",
    "write_structured_grid",
    "write_structured_points",
]
