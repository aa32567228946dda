"""Port: data/volumes.py against the JAX package: CT and SDF volumes read
from STRUCTURED_POINTS files and from shuffled STRUCTURED_GRID files (the
KDTree regrid), the transfer-function VTK byte for byte, and the
ground-truth VTK's lattice and scalars."""

import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.data.volumes import export_ground_truth_vtk as export_gt_j
from nerf_for_angiography_tpu.data.volumes import export_transferfunc_vtk as export_tf_j
from nerf_for_angiography_tpu.data.volumes import load_ct_volume as load_ct_volume_j
from nerf_for_angiography_tpu.data.volumes import load_sdf_volume as load_sdf_volume_j
from nerf_for_angiography_tpu.ops.interpolation import RegularGrid as RegularGrid_j
from nerf_for_angiography_tpu_torch.data import rev_sigmoid, transfer_func_ct
from nerf_for_angiography_tpu_torch.data.volumes import (
    export_ground_truth_vtk,
    export_transferfunc_vtk,
    load_ct_volume,
    load_sdf_volume,
)
from nerf_for_angiography_tpu_torch.ops.interpolation import RegularGrid, trilinear
from nerf_for_angiography_tpu_torch.utils import (
    read_vtk,
    write_structured_grid,
    write_structured_points,
)

TOL = dict(rtol=1e-6, atol=1e-6)


def _volume_file(tmp_path, kind: str, sdf: bool) -> str:
    """A 7 x 8 x 9 volume with a non-unit spacing and origin, as
    STRUCTURED_POINTS or as a STRUCTURED_GRID whose points are shuffled."""
    rs = np.random.RandomState(0)
    shape = (7, 8, 9)
    vals = (rs.rand(*shape) * 4 - 2 if sdf else rs.rand(*shape) * 4200 - 100).astype(np.float32)
    origin, spacing = (-3.0, 1.5, 10.0), (0.5, 1.25, 2.0)
    path = str(tmp_path / f"{kind}.vtk")
    if kind == "points":
        write_structured_points(path, vals, origin=origin, spacing=spacing, name="scalars")
        return path
    axes = [o + s * np.arange(n) for o, s, n in zip(origin, spacing, shape)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)
    perm = rs.permutation(pts.shape[0])
    write_structured_grid(path, pts[perm], shape, {"scalars": vals.ravel()[perm]})
    return path


def _assert_grid(got: RegularGrid, want: RegularGrid_j) -> None:
    for f in ("values", "origin", "spacing", "fill_value"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   err_msg=f, **TOL)


@pytest.mark.parametrize("kind", ["points", "grid"])
@pytest.mark.parametrize("binary", [False, True])
def test_load_ct_volume_matches_jax(tmp_path, kind, binary):
    path = _volume_file(tmp_path, kind, sdf=False)
    _assert_grid(load_ct_volume(path, binary=binary), load_ct_volume_j(path, binary=binary))
    kw = dict(translation=(1.0, -2.0, 0.5), extra_translation=(0.0, 0.0, 0.0))
    _assert_grid(load_ct_volume(path, **kw), load_ct_volume_j(path, **kw))


@pytest.mark.parametrize("kind", ["points", "grid"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_load_sdf_volume_matches_jax(tmp_path, kind, scale):
    path = _volume_file(tmp_path, kind, sdf=True)
    _assert_grid(load_sdf_volume(path, scale=scale), load_sdf_volume_j(path, scale=scale))


@pytest.mark.parametrize("kind", ["points", "grid"])
def test_lattice_nodes_sample_the_transfer_of_the_raw_values(tmp_path, kind):
    """Trilinear at a node of the loaded grid returns the transfer function
    of that node's raw value (the regrid put every point back in place)."""
    path = _volume_file(tmp_path, kind, sdf=False)
    raw = read_vtk(path)
    vol = load_ct_volume(path, extra_translation=(0.0, 0.0, 0.0))
    i = np.array([2, 5, 3])
    node = vol.origin + vol.spacing * torch.from_numpy(i).float()
    if kind == "points":
        want = transfer_func_ct(raw.scalars_3d("scalars")[tuple(i)])
    else:
        pts = np.round(raw.points, 3)
        at = np.flatnonzero((pts == pts.min(0) + np.array([0.5, 1.25, 2.0]) * i).all(1))
        want = transfer_func_ct(raw.point_data["scalars"][at[0]])
    assert float(trilinear(vol, node[None])[0]) == pytest.approx(float(want), abs=1e-6)
    sdf = load_sdf_volume(_volume_file(tmp_path, kind, sdf=True))
    g = read_vtk(str(tmp_path / f"{kind}.vtk"))
    if kind == "points":
        corner = g.scalars_3d("scalars")[0, 0, 0]
    else:
        pts = np.round(g.points, 3)
        corner = g.point_data["scalars"][np.flatnonzero((pts == pts.min(0)).all(1))[0]]
    assert float(sdf.values.min()) >= 0.0 and float(sdf.values.max()) <= 1.0
    assert float(sdf.values[0, 0, 0]) == float(rev_sigmoid(np.float32(corner), c1=2.0))


def _grids(tmp_path):
    """One volume in both packages' types, the same numbers."""
    vol_j = load_ct_volume_j(_volume_file(tmp_path, "points", sdf=False),
                             extra_translation=(0.0, 0.0, 0.0))
    vol = RegularGrid.create(np.asarray(vol_j.values), np.asarray(vol_j.origin),
                             np.asarray(vol_j.spacing), float(vol_j.fill_value))
    return vol, vol_j


@pytest.mark.parametrize("binary", [False, True])
def test_transferfunc_vtk_is_the_jax_file(tmp_path, binary):
    vol, vol_j = _grids(tmp_path)
    export_transferfunc_vtk(vol, str(tmp_path / "p.vtk"), binary=binary)
    export_tf_j(vol_j, str(tmp_path / "j.vtk"), binary=binary)
    assert (tmp_path / "p.vtk").read_bytes() == (tmp_path / "j.vtk").read_bytes()


def test_ground_truth_vtk_matches_jax(tmp_path):
    """A 16^3 lattice that straddles the centred volume's edges: the same
    header and lattice bytes, scalars within 1e-6."""
    vol, vol_j = _grids(tmp_path)
    export_ground_truth_vtk(vol, str(tmp_path / "p.vtk"), extent=6.0, res=16)
    export_gt_j(vol_j, str(tmp_path / "j.vtk"), extent=6.0, res=16)
    got, want = read_vtk(str(tmp_path / "p.vtk")), read_vtk(str(tmp_path / "j.vtk"))
    assert got.dimensions == want.dimensions == (16, 16, 16)
    np.testing.assert_array_equal(got.points, want.points)
    g, w = got.point_data["scalars"], want.point_data["scalars"]
    assert 0.05 < (w > 0).mean() < 0.95
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    head = (tmp_path / "j.vtk").read_bytes().index(b"POINT_DATA")
    assert (tmp_path / "p.vtk").read_bytes()[:head] == (tmp_path / "j.vtk").read_bytes()[:head]
