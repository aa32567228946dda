"""Minimal legacy-VTK reader/writer (pure Python + numpy; a copy of
``nerf_for_angiography_tpu/utils/vtk.py``, which the port does not import).

The reference uses pyvista for all volume/grid IO (cttoray.py:125-148,
run_nerf_acc.py:200-204,359-367, visualization.py:158-177,235-237). Every
file the pipeline touches is legacy-VTK STRUCTURED_POINTS (uniform grids: CT
volume, occupancy grids) or STRUCTURED_GRID (lattice point clouds:
ground-truth / prediction fields). This module implements exactly those two,
ASCII and binary (big-endian, per the VTK legacy spec), with POINT_DATA and
CELL_DATA scalars, byte-compatible with what pyvista reads/writes. The
files carry the JAX package's title line, so both packages write the same
bytes for the same grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_VTK_TO_NP = {
    "float": ">f4",
    "double": ">f8",
    "int": ">i4",
    "long": ">i8",
    "unsigned_char": ">u1",
    "char": ">i1",
    "short": ">i2",
    "unsigned_short": ">u2",
    "unsigned_int": ">u4",
    "bit": ">u1",
}
_NP_TO_VTK = {
    "float32": "float",
    "float64": "double",
    "int32": "int",
    "int64": "long",
    "uint8": "unsigned_char",
    "int8": "char",
    "int16": "short",
    "uint16": "unsigned_short",
    "uint32": "unsigned_int",
    "bool": "unsigned_char",
}


@dataclasses.dataclass
class VtkGrid:
    """A structured VTK dataset.

    kind: 'structured_points' | 'structured_grid'
    dimensions: (nx, ny, nz) point dimensions
    origin/spacing: for structured_points
    points: (N, 3) for structured_grid (VTK x-fastest order)
    point_data / cell_data: name -> flat array (VTK x-fastest order)
    """

    kind: str
    dimensions: tuple[int, int, int]
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0)
    points: np.ndarray | None = None
    point_data: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    cell_data: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def n_points(self) -> int:
        nx, ny, nz = self.dimensions
        return nx * ny * nz

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.dimensions
        return max(nx - 1, 1) * max(ny - 1, 1) * max(nz - 1, 1)

    def scalars_3d(self, name: str = "scalars", cell: bool = False) -> np.ndarray:
        """Reshape flat VTK-order (x fastest) data to (nx, ny, nz) C-order."""
        nx, ny, nz = self.dimensions
        if cell:
            nx, ny, nz = max(nx - 1, 1), max(ny - 1, 1), max(nz - 1, 1)
            flat = self.cell_data[name]
        else:
            flat = self.point_data[name]
        return np.asarray(flat).reshape(nz, ny, nx).transpose(2, 1, 0)

    def bounds(self) -> tuple[float, float, float, float, float, float]:
        if self.kind == "structured_points":
            nx, ny, nz = self.dimensions
            ox, oy, oz = self.origin
            sx, sy, sz = self.spacing
            return (ox, ox + sx * (nx - 1), oy, oy + sy * (ny - 1), oz, oz + sz * (nz - 1))
        p = self.points
        return (
            float(p[:, 0].min()), float(p[:, 0].max()),
            float(p[:, 1].min()), float(p[:, 1].max()),
            float(p[:, 2].min()), float(p[:, 2].max()),
        )


def flat_vtk_order(values_xyz: np.ndarray) -> np.ndarray:
    """(nx, ny, nz) C-order array -> flat VTK order (x varies fastest)."""
    return np.ascontiguousarray(values_xyz.transpose(2, 1, 0)).reshape(-1)


def write_structured_points(
    path: str,
    values,
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
    name: str = "values",
    cell: bool = False,
    binary: bool = False,
) -> None:
    """Write a uniform grid. ``values`` is (nx, ny, nz); if ``cell`` the grid
    gets point dims values.shape + 1 and the array is CELL_DATA (matching
    the occupancy-grid export at run_nerf_acc.py:200-204,359-367)."""
    values = np.asarray(values)
    if values.dtype == bool:
        values = values.astype(np.uint8)
    if cell:
        dims = tuple(s + 1 for s in values.shape)
    else:
        dims = values.shape
    flat = flat_vtk_order(values)
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\n")
        f.write(b"nerf_for_angiography_tpu\n")
        f.write(b"BINARY\n" if binary else b"ASCII\n")
        f.write(b"DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n".encode())
        f.write(f"ORIGIN {origin[0]} {origin[1]} {origin[2]}\n".encode())
        f.write(f"SPACING {spacing[0]} {spacing[1]} {spacing[2]}\n".encode())
        section = b"CELL_DATA" if cell else b"POINT_DATA"
        f.write(section + f" {flat.size}\n".encode())
        _write_scalars(f, name, flat, binary)


def write_structured_grid(
    path: str,
    points: np.ndarray,
    dimensions: tuple[int, int, int],
    point_data: dict[str, np.ndarray],
    binary: bool = False,
) -> None:
    """Write a structured grid (lattice point cloud + scalars), as used for
    ground-truth.vtk (cttoray.py:146-148) and prediction-field exports
    (visualization.py:235-237). ``points`` must be in VTK x-fastest order."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\n")
        f.write(b"nerf_for_angiography_tpu\n")
        f.write(b"BINARY\n" if binary else b"ASCII\n")
        f.write(b"DATASET STRUCTURED_GRID\n")
        f.write(
            f"DIMENSIONS {dimensions[0]} {dimensions[1]} {dimensions[2]}\n".encode()
        )
        f.write(f"POINTS {points.shape[0]} float\n".encode())
        if binary:
            f.write(points.astype(">f4").tobytes())
            f.write(b"\n")
        else:
            np.savetxt(f, points, fmt="%.6g")
        f.write(f"POINT_DATA {points.shape[0]}\n".encode())
        for name, arr in point_data.items():
            _write_scalars(f, name, np.asarray(arr).reshape(-1), binary)


def _write_scalars(f, name: str, flat: np.ndarray, binary: bool) -> None:
    vtk_type = _NP_TO_VTK[str(flat.dtype)]
    f.write(f"SCALARS {name} {vtk_type}\n".encode())
    f.write(b"LOOKUP_TABLE default\n")
    if binary:
        f.write(flat.astype(_VTK_TO_NP[vtk_type]).tobytes())
        f.write(b"\n")
    else:
        np.savetxt(f, flat.reshape(-1, 1), fmt="%.9g")


def read_vtk(path: str) -> VtkGrid:
    """Read a legacy VTK STRUCTURED_POINTS or STRUCTURED_GRID file
    (ASCII or binary)."""
    with open(path, "rb") as f:
        data = f.read()

    # header: 4-5 text lines regardless of format
    pos = 0

    def next_line():
        nonlocal pos
        end = data.index(b"\n", pos)
        line = data[pos:end].decode("ascii", "replace").strip()
        pos = end + 1
        return line

    next_line()  # version
    next_line()  # title
    fmt = next_line().upper()
    binary = fmt == "BINARY"
    dataset = next_line().split()
    assert dataset[0].upper() == "DATASET", f"bad VTK file {path}"
    kind = dataset[1].upper()

    grid = VtkGrid(kind=kind.lower(), dimensions=(0, 0, 0))

    def read_array(n, vtk_type):
        nonlocal pos
        dt = np.dtype(_VTK_TO_NP[vtk_type])
        if binary:
            nbytes = n * dt.itemsize
            arr = np.frombuffer(data[pos : pos + nbytes], dtype=dt).astype(
                dt.newbyteorder("=")
            )
            pos += nbytes
            if pos < len(data) and data[pos : pos + 1] == b"\n":
                pos += 1
            return arr
        vals = []
        while len(vals) < n:
            vals.extend(next_line().split())
        return np.array(vals[:n], dtype=dt.newbyteorder("="))

    n_points = 0
    section = None  # 'point' | 'cell'
    while pos < len(data):
        try:
            line = next_line()
        except ValueError:
            break
        if not line:
            continue
        tok = line.split()
        key = tok[0].upper()
        if key == "DIMENSIONS":
            grid.dimensions = tuple(int(t) for t in tok[1:4])
            n_points = grid.n_points
        elif key == "ORIGIN":
            grid.origin = tuple(float(t) for t in tok[1:4])
        elif key == "SPACING" or key == "ASPECT_RATIO":
            grid.spacing = tuple(float(t) for t in tok[1:4])
        elif key == "POINTS":
            n = int(tok[1])
            arr = read_array(n * 3, tok[2])
            grid.points = arr.reshape(-1, 3).astype(np.float32)
        elif key == "POINT_DATA":
            section = "point"
            n_points = int(tok[1])
        elif key == "CELL_DATA":
            section = "cell"
            n_points = int(tok[1])
        elif key == "SCALARS":
            name, vtk_type = tok[1], tok[2]
            # optional numComp token (tok[3]); next line is LOOKUP_TABLE
            comps = int(tok[3]) if len(tok) > 3 else 1
            lut = next_line()
            if not lut.upper().startswith("LOOKUP_TABLE"):
                raise ValueError(f"expected LOOKUP_TABLE in {path}")
            arr = read_array(n_points * comps, vtk_type)
            target = grid.point_data if section == "point" else grid.cell_data
            target[name] = arr
        elif key in ("FIELD", "LOOKUP_TABLE", "METADATA", "VECTORS", "NORMALS"):
            # skip unsupported sections conservatively (ASCII only)
            continue
    return grid
