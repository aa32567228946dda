"""Port: the CSV data contract against the JAX package (the proj and rays
writers byte for byte, ``load_data`` native and plain in both directions,
``proj_images_from_csv`` / ``map_column_to_np``), the column-table CSV
against pandas, the native library loader (its builds, failures and the
JSON writer against ``json``), and the weight-map PNG against
``plt.imsave``."""

import filecmp
import io
import json
import tempfile

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from nerf_for_angiography_tpu.data import DatagenConfig as DatagenConfig_j
from nerf_for_angiography_tpu.data import generate_dataset as generate_dataset_j
from nerf_for_angiography_tpu.data import load_data as load_data_j
from nerf_for_angiography_tpu.data import make_lca_sdf_volume as make_lca_sdf_volume_j
from nerf_for_angiography_tpu.data import make_vessel_volume as make_vessel_volume_j
from nerf_for_angiography_tpu.data import write_proj_csv as write_proj_csv_j
from nerf_for_angiography_tpu.data import write_rays_csv as write_rays_csv_j
from nerf_for_angiography_tpu.data.datasets import map_column_to_np as map_column_to_np_j
from nerf_for_angiography_tpu.data.datasets import proj_images_from_csv as proj_images_j
from nerf_for_angiography_tpu.data.datasets import sdf_datagen_config as sdf_datagen_config_j
from nerf_for_angiography_tpu_torch import native
from nerf_for_angiography_tpu_torch.cli.datagen import csv_file_names
from nerf_for_angiography_tpu_torch.data import (
    DatagenConfig,
    GeneratedDataset,
    generate_dataset,
    load_data,
    make_vessel_volume,
    write_proj_csv,
    write_rays_csv,
)
from nerf_for_angiography_tpu_torch.data.datasets import (
    map_column_to_np,
    proj_images_from_csv,
    sdf_datagen_config,
)
from nerf_for_angiography_tpu_torch.ops.sampling import RayDataset
from nerf_for_angiography_tpu_torch.utils import (
    colormap_rgba,
    read_csv_table,
    read_png_rgba,
    write_csv_table,
    write_png_colormap,
)

RAY_FIELDS = ("origins", "directions", "pixel_values", "weights", "image_ids", "x_positions",
              "y_positions")
SMALL_CT = dict(limited_size=90.0, number_angles=2.0, img_width=9, img_height=7,
                sample_outside=20.0)
SMALL_LCA = dict(img_width=12, img_height=10, sample_outside=60.0)
# the JAX datagen CLI's names for these cases (cli/datagen.py:118-130)
CASES = {
    "ct": (dict(SMALL_CT), False,
           ("df-background-90.0-2.0-[90.0, 0.0]--cttoproj.csv",
            "df-rays-background-90.0-2.0-[90.0, 0.0]--7.csv")),
    "ct-binary": (dict(SMALL_CT, binary=True), False,
                  ("df-limited-sparse-90.0-2.0-[90.0, 0.0]-binary-cttoproj.csv",
                   "df-rays-limited-sparse-90.0-2.0-[90.0, 0.0]-binary-7.csv")),
    "clinical": (dict(SMALL_CT, number_angles=0.0), False,
                 ("df-clinical-angles--cttoproj.csv", "df-rays-clinical-angles--7.csv")),
    "lca": (dict(SMALL_LCA), True,
            ("df-background-25.0-4.0-[90.0, 0.0]--sdftoproj.csv",
             "df-rays-background-25.0-4.0-[90.0, 0.0]--10.csv")),
}


def _jax_dataset(kw: dict, sdf: bool):
    if sdf:
        return generate_dataset_j(make_lca_sdf_volume_j(res=24), sdf_datagen_config_j(**kw))
    return generate_dataset_j(make_vessel_volume_j(res=16), DatagenConfig_j(**kw),
                              key=jax.random.PRNGKey(3))


def _port_types(ds_j) -> GeneratedDataset:
    """The JAX dataset in the port's types: the DataFrame as a column table
    of lists, the rays as CPU tensors."""
    proj = {c: ds_j.proj[c].tolist() for c in ds_j.proj.columns}
    rays = RayDataset(**{f: torch.from_numpy(np.array(getattr(ds_j.rays, f)))
                         for f in RAY_FIELDS})
    return GeneratedDataset(proj=proj, rays=rays, images=ds_j.images,
                            weight_maps=ds_j.weight_maps, angles=ds_j.angles)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each case's JAX dataset written by both packages' writers under the
    names the port's datagen CLI gives them."""
    out = {}
    for name, (kw, sdf, _) in CASES.items():
        d = tmp_path_factory.mktemp(name)
        ds_j = _jax_dataset(kw, sdf)
        cfg = sdf_datagen_config(**kw) if sdf else DatagenConfig(**kw)
        proj_name, rays_name = csv_file_names(cfg, sdf)
        paths = {}
        for side, (wp, wr, ds) in {"jax": (write_proj_csv_j, write_rays_csv_j, ds_j),
                                   "port": (write_proj_csv, write_rays_csv,
                                            _port_types(ds_j))}.items():
            (d / side).mkdir()
            paths[side] = (str(d / side / proj_name), str(d / side / rays_name))
            wp(ds, paths[side][0])
            wr(ds, paths[side][1])
        out[name] = dict(ds_j=ds_j, paths=paths, names=(proj_name, rays_name))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_csv_file_names_are_the_jax_clis(case):
    kw, sdf, want = CASES[case]
    cfg = sdf_datagen_config(**kw) if sdf else DatagenConfig(**kw)
    assert csv_file_names(cfg, sdf) == want


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("which", [0, 1], ids=["proj", "rays"])
def test_writers_write_the_jax_bytes(written, case, which):
    """The same dataset through both packages' writers: the same file, byte
    for byte."""
    p = written[case]["paths"]
    assert filecmp.cmp(p["jax"][which], p["port"][which], shallow=False)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("native_loader", [True, False], ids=["native", "csv"])
def test_load_data_agrees_with_jax_both_ways(written, case, native_loader):
    """The port's load_data on JAX-written CSVs and JAX's on port-written ones
    give the JAX load_data's arrays: floats bit for bit in f32, indices
    equal (int64 in the port, as its RayDataset holds them)."""
    p = written[case]["paths"]
    want = load_data_j(*p["jax"], use_native=native_loader)
    got = load_data(*p["jax"], use_native=native_loader, device="cpu")
    back = load_data_j(*p["port"], use_native=native_loader)
    for f in RAY_FIELDS:
        w, g = np.asarray(getattr(want.rays, f)), getattr(got.rays, f).numpy()
        assert g.dtype == (np.float32 if w.dtype == np.float32 else np.int64), f
        np.testing.assert_array_equal(g, w, err_msg=f)
        np.testing.assert_array_equal(np.asarray(getattr(back.rays, f)), w, err_msg=f)
    for k in ("focal_length", "near_thresh", "far_thresh", "depth_samples", "src_pt_z",
              "num_views", "rays_per_view"):
        assert getattr(got, k) == getattr(want, k), k
    assert (got.ray_df is None) == native_loader
    if not native_loader:
        assert list(got.ray_df) == list(want.ray_df.columns)
        assert list(got.ray_df["image_id"]) == want.ray_df["image_id"].astype(str).tolist()
    assert list(got.proj_df) == list(want.proj_df.columns)
    for c in want.proj_df.columns:
        col = want.proj_df[c]
        if col.dtype.kind in "biuf":
            assert got.proj_df[c].dtype == col.dtype, c
            np.testing.assert_array_equal(got.proj_df[c], col.to_numpy(), err_msg=c)
        else:
            assert list(got.proj_df[c]) == col.tolist(), c


@pytest.mark.parametrize("case", ["ct", "lca"])
def test_proj_images_and_list_columns_equal_jax(written, case):
    proj = written[case]["paths"]["port"][0]
    for got, want in zip(proj_images_from_csv(proj), proj_images_j(proj)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    table = read_csv_table(proj)
    df = pd.read_csv(proj, sep=";", index_col=0)
    for c in ("tform_cam2world", "depth_values", "image_data", "org_img_width", "theta"):
        got, want = map_column_to_np(table, c), map_column_to_np_j(df, c)
        assert got.dtype == want.dtype, c
        np.testing.assert_array_equal(got, want, err_msg=c)


def test_port_datagen_proj_table_has_the_jax_columns():
    """The port's own generate_dataset: its proj table has JAX's columns in
    order; the angle and scalar columns are written as JAX writes them, the
    rendered images, weight maps and camera matrices within their f32
    renders' difference (2e-5), the depths within one f32 ulp (torch's and
    XLA's linspace round apart); its CSVs load back bit-equal to its
    in-memory rays."""
    kw = dict(SMALL_CT, stratified_depths=False)
    ds_j = generate_dataset_j(make_vessel_volume_j(res=16), DatagenConfig_j(**kw))
    ds = generate_dataset(make_vessel_volume(res=16), DatagenConfig(**kw), device="cpu")
    assert list(ds.proj) == list(ds_j.proj.columns)
    buf = io.StringIO()
    ds_j.proj.to_csv(buf, sep=";")
    buf.seek(0)
    want = pd.read_csv(buf, sep=";", index_col=0, dtype=str, keep_default_na=False)
    approx = ("tform_cam2world", "unshifted_tform_cam2world", "image_data",
              "image_distance_data")
    with tempfile.TemporaryDirectory() as d:
        write_proj_csv(ds, f"{d}/p.csv")
        write_rays_csv(ds, f"{d}/r.csv")
        got = pd.read_csv(f"{d}/p.csv", sep=";", index_col=0, dtype=str, keep_default_na=False)
        loaded = load_data(f"{d}/p.csv", f"{d}/r.csv", device="cpu")
    for c in want.columns:
        if c in approx:
            np.testing.assert_allclose(map_column_to_np_j(got, c), map_column_to_np_j(want, c),
                                       rtol=0, atol=2e-5, err_msg=c)
        elif c == "depth_values":
            np.testing.assert_array_max_ulp(
                map_column_to_np_j(got, c).astype(np.float32),
                map_column_to_np_j(want, c).astype(np.float32), maxulp=1)
        else:
            assert got[c].tolist() == want[c].tolist(), c
    for f in RAY_FIELDS:
        assert torch.equal(getattr(loaded.rays, f), getattr(ds.rays, f)), f


def test_csv_table_is_pandas_both_ways(tmp_path):
    """write_csv_table against DataFrame.to_csv (NaN and None as empty cells,
    float32 / float64 / int / bool / str / list cells) and read_csv_table
    against read_csv's typed columns."""
    rng = np.random.default_rng(0)
    table = {
        "f64": np.concatenate([rng.standard_normal(5) * 1e-7, [np.nan, 1e16, 0.0]]),
        "f32": np.concatenate([rng.standard_normal(7), [np.nan]]).astype(np.float32),
        "i": np.arange(8) - 3,
        "b": np.arange(8) % 3 == 0,
        "s": [f"{t}-0,0" for t in range(-4, 4)],
        "lst": [rng.standard_normal((2, 2)).tolist() for _ in range(7)] + [None],
        "arr": rng.standard_normal((8, 3)).astype(np.float32),
    }
    write_csv_table(table, str(tmp_path / "t.csv"))
    buf = io.StringIO()
    # an array row is a cell of its nested list, as the JAX tables hold lists
    pd.DataFrame({k: [r.tolist() for r in v] if isinstance(v, np.ndarray) and v.ndim > 1
                  else v for k, v in table.items()}).to_csv(buf, sep=";")
    assert (tmp_path / "t.csv").read_text() == buf.getvalue()
    got = read_csv_table(str(tmp_path / "t.csv"))
    # round_trip: pandas' default float parser can miss the written value by
    # an ulp; read_csv_table parses correctly rounded, as the native loader
    want = pd.read_csv(str(tmp_path / "t.csv"), sep=";", index_col=0,
                       float_precision="round_trip")
    assert list(got) == list(want.columns)
    for c in ("f64", "f32", "i", "b"):
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c].to_numpy(), err_msg=c)
    assert got["s"] == want["s"].tolist()


def test_csv_reader_takes_cells_above_the_default_field_limit(tmp_path):
    big = np.random.default_rng(3).random((1, 150 * 162))
    write_csv_table({"image_data": big}, str(tmp_path / "big.csv"))
    assert len((tmp_path / "big.csv").read_text()) > 131_072
    np.testing.assert_array_equal(map_column_to_np(read_csv_table(str(tmp_path / "big.csv")),
                                                   "image_data"), big)


def test_native_loader_refuses_what_it_cannot_parse(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text(";image_id;pixel_value\n0;0,0-0,0;0.5\n")
    with pytest.raises(ValueError, match="parsed"):
        native.load_rays_csv(str(bad))
    with pytest.raises(FileNotFoundError):
        native.load_rays_csv(str(tmp_path / "missing.csv"))


def test_native_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    (src / "csv_loader.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="csv_loader.cpp failed"):
        native.get_lib("csvloader")
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_builds_outside_the_jax_packages_build():
    lib = native.get_lib("jsonexport")
    assert "nerf_for_angiography_tpu_torch/build/libjsonexport_" in lib._name


def _json_values(obj: dict) -> dict:
    return json.loads(json.dumps(obj))


@pytest.mark.parametrize("kind", ["random", "sweep"])
def test_native_json_equals_the_json_module(tmp_path, kind):
    """The native writer's files, loaded, equal what json.dumps wrote, value
    for value: random f64 over 40 decades with integral values among them,
    and sweep images (f32 values in [0, 1], rounded to 10 decimals as the
    sweep keeps them)."""
    rng = np.random.default_rng(1)
    n = 4000
    if kind == "random":
        pred = rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)
        org = np.round(rng.standard_normal(n) * 100)
    else:
        pred = np.round(rng.random(n).astype(np.float32), 10).astype(float)
        org = rng.random(n).astype(np.float32).astype(float)
    diff = np.abs(pred - org)
    native.write_angle_json(str(tmp_path / "a.json"), pred, org, diff)
    with open(tmp_path / "a.json") as f:
        got = json.load(f)
    assert got == _json_values({"pred": pred.tolist(), "org": org.tolist(),
                                "diff": diff.tolist()})
    rad, theta, vals = rng.random(50), rng.standard_normal(50), pred[:50]
    angles = np.stack([np.round(rng.uniform(-180, 180, 50)), rng.uniform(-180, 180, 50)], -1)
    native.write_heatmap_json(str(tmp_path / "h.json"), rad, theta, angles, vals)
    with open(tmp_path / "h.json") as f:
        got = json.load(f)
    assert got == _json_values({"rad": rad.tolist(), "theta": theta.tolist(),
                                "angles": angles.tolist(), "vals": vals.tolist()})
    assert list(got) == ["rad", "theta", "angles", "vals"]


def test_native_json_writer_failures_raise(tmp_path):
    with pytest.raises(OSError):
        native.write_angle_json(str(tmp_path / "no" / "dir.json"), [1.0], [1.0], [0.0])
    with pytest.raises(ValueError, match="sizes"):
        native.write_angle_json(str(tmp_path / "a.json"), [1.0, 2.0], [1.0], [0.0])
    with pytest.raises(ValueError, match="sizes"):
        native.write_heatmap_json(str(tmp_path / "h.json"), [1.0], [1.0], [1.0], [1.0])


@pytest.mark.parametrize("img", ["weights", "flat", "f32"])
def test_weight_map_png_is_plt_imsave(tmp_path, img):
    """The datagen's weight-map PNG against matplotlib's imsave (viridis,
    autoscaled, RGBA): within one uint8 level a channel (it reads 0)."""
    plt = pytest.importorskip("matplotlib.pyplot")
    from PIL import Image

    rng = np.random.default_rng(2)
    a = {"weights": np.abs(rng.standard_normal((13, 17))) + 1e-10,
         "flat": np.ones((6, 5)),
         "f32": rng.random((8, 9)).astype(np.float32) * 3 - 1}[img]
    plt.imsave(str(tmp_path / "m.png"), a)
    write_png_colormap(str(tmp_path / "p.png"), a)
    want = np.asarray(Image.open(tmp_path / "m.png").convert("RGBA")).astype(np.int32)
    got = read_png_rgba(str(tmp_path / "p.png")).astype(np.int32)
    assert got.shape == want.shape == a.shape + (4,)
    assert np.abs(got - want).max() <= 1
    np.testing.assert_array_equal(got, colormap_rgba(a))


def test_metrics_csv_writes_nan_as_pandas_does(tmp_path):
    """df-metrics.csv with a NaN metric (SSIM is NaN on views below its
    window, as in JAX): an empty cell, as to_csv writes it (the port wrote
    'nan' before the CSV table)."""
    from nerf_for_angiography_tpu_torch.evaluation.sweep import write_metrics_csv

    table = {"theta": np.array([0.0, 90.0]), "SSIM": np.array([np.nan, 0.5]),
             "PSNR": np.array([np.float32(20.5), np.float32(np.nan)]),
             "pred_img": np.zeros((2, 4), np.float32)}
    write_metrics_csv(table, str(tmp_path / "m.csv"))
    buf = io.StringIO()
    pd.DataFrame({k: v for k, v in table.items() if k != "pred_img"}).to_csv(buf, sep=";")
    assert (tmp_path / "m.csv").read_text() == buf.getvalue()
