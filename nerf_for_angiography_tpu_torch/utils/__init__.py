"""numpy-only helpers: the legacy-VTK reader/writer."""

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
    "read_vtk",
    "write_structured_grid",
    "write_structured_points",
]
