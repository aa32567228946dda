"""Port: the command-line pipeline against the JAX package: parse_train_args
on argv lists that touch every flag, the four entry points run in-process at
the JAX pipeline test's tiny sizes against the JAX CLIs on the same
arguments (the same files, the same CSV headers, the same analysis table),
load_experiments against the JAX loader, and the analysis plot."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from nerf_for_angiography_tpu.analysis import load_experiments as load_experiments_j
from nerf_for_angiography_tpu.training.config import parse_train_args as parse_train_args_j
from nerf_for_angiography_tpu_torch.analysis import (
    apply_filters,
    load_experiments,
    plot_metric_vs_limited_angle,
)
from nerf_for_angiography_tpu_torch.cli import analyze, datagen, evaluate, train
from nerf_for_angiography_tpu_torch.training import parse_train_args
from nerf_for_angiography_tpu_torch.training.config import train_arg_parser
from nerf_for_angiography_tpu_torch.utils import write_csv_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRAIN_ARGV = [
    [],
    ["--limited_size", "120", "--number_angles", "3", "--center_point", "[45, 10]",
     "--binary", "True", "--sampling_strategy", "segmentation", "--data_name", "LCA",
     "--num_layers", "3", "--num_hidden_units", "64", "--data_dir", "elsewhere"],
    ["--n_iters", "123", "--grid_resolution", "64", "--depth_samples", "200",
     "--display_every", "7", "--pose_lr", "0.5", "--march_mode", "hybrid",
     "--mlp_backend", "xla", "--feature_major_mlp", "--fused_train_step", "on",
     "--sampling_impl", "gumbel"],
    ["--reference-strict"],
    ["--reference-strict", "--carve_init", "True", "--compact_engage_max", "96",
     "--hybrid_split", "0.5", "--hybrid_bucket_k", "True"],
    ["--carve_init", "False", "--compact_engage_max", "0", "--hybrid_split", "0",
     "--hybrid_bucket_k", "False", "--binary", "False", "--mlp_backend", "pallas",
     "--march_mode", "lattice", "--fused_train_step", "auto"],
]


@pytest.mark.parametrize("argv", TRAIN_ARGV, ids=range(len(TRAIN_ARGV)))
def test_parse_train_args_matches_jax(argv):
    cfg, data_dir = parse_train_args(argv)
    cfg_j, data_dir_j = parse_train_args_j(argv)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert data_dir == data_dir_j


def test_parse_train_args_device_and_pose_refine():
    """--device defaults to the card; --pose_refine (with --pose_lr) gives
    the JAX package's config, now that the port takes it."""
    assert train_arg_parser().parse_args([]).device == "cuda"
    assert train_arg_parser().parse_args(["--device", "cpu"]).device == "cpu"
    argv = ["--pose_refine", "--pose_lr", "0.05"]
    cfg, data_dir = parse_train_args(argv)
    cfg_j, data_dir_j = parse_train_args_j(argv)
    assert cfg.pose_refine and cfg.pose_lr == 0.05
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j) and data_dir == data_dir_j


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    for main in (datagen.main, train.main, evaluate.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])


def test_train_without_csvs_exits(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="cli.datagen first"):
        train.main(["--device", "cpu"])


# the JAX pipeline test's tiny sizes (tests/test_cli_pipeline.py)
DATAGEN = ["--limited_size", "90", "--number_angles", "2", "--img_size", "16",
           "--volume", "phantom:sphere", "--out", "data"]
TRAIN = ["--n_iters", "30", "--grid_resolution", "8", "--depth_samples", "32",
         "--display_every", "15"]
EVALUATE = ["--data_name", "ct", "--volume", "phantom:sphere", "--number_angles_vis", "2",
            "--img_size", "16", "--depth_samples", "32", "--field_resolution", "9",
            "--no_videos", "--no_perceptual"]
ANALYZE = ["--cases_root", "cases", "--out", "plot.png"]

_JAX_PIPELINE = """
import importlib.util, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
for name, argv in {steps!r}:
    path = os.path.join({repo!r}, "cli", name + ".py")
    spec = importlib.util.spec_from_file_location("jax_cli_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(argv)
"""


def _files(root) -> set:
    """Every file under root, the run directory's minute and the event
    file's time and host left out."""
    out = set()
    for d, _, names in os.walk(root):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), root)
            rel = re.sub(r"runs/[^/]+/", "runs/RUN/", rel)
            out.add(re.sub(r"events\.out\.tfevents\..*", "events.out.tfevents", rel))
    return out


def _header(path) -> str:
    with open(path) as f:
        return f.readline()


def test_cli_pipeline_writes_what_the_jax_clis_write(tmp_path, monkeypatch):
    """datagen -> train -> evaluate -> analyze through the port's entry points
    with --device cpu (~17 s), and the JAX CLIs on the same arguments in
    one process (~45 s, most of it XLA compiles): the same
    files (CSVs, PNGs, VTKs, run directory, df-metrics.csv, the cag-vis
    JSONs, the plot), the same CSV headers and row counts, and
    load_experiments of each run equal to the JAX loader's."""
    jax_ws, ws = tmp_path / "jax", tmp_path / "port"
    jax_ws.mkdir()
    ws.mkdir()
    steps = [("datagen", DATAGEN), ("train", TRAIN), ("evaluate", EVALUATE),
             ("analyze", ANALYZE)]
    # one CPU device (conftest's XLA_FLAGS would give the JAX CLIs an
    # 8-device mesh), the compile cache in the test's directory
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"),
               PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", _JAX_PIPELINE.format(steps=steps, repo=REPO)],
                          cwd=jax_ws, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    monkeypatch.chdir(ws)
    written = datagen.main(DATAGEN + ["--device", "cpu"])
    result = train.main(TRAIN + ["--device", "cpu"])
    tables = evaluate.main(EVALUATE + ["--device", "cpu"])
    loaded = analyze.main(ANALYZE)

    files = _files(ws)
    assert files == _files(jax_ws)
    assert {f for f in files if f.endswith(".csv")} == {
        "data/ct/df-background-90.0-2.0-[90.0, 0.0]--cttoproj.csv",
        "data/ct/df-rays-background-90.0-2.0-[90.0, 0.0]--16.csv",
        "cases/ct/runs/RUN/df-metrics.csv"}
    assert sum(f.startswith("data/ct/projections/image-transform-") for f in files) == 10
    (run_dir,) = tables
    (jax_run,) = (jax_ws / "cases" / "ct" / "runs").iterdir()
    for port_csv, jax_csv in ((written["proj_csv"], "data/ct/" + os.path.basename(
            written["proj_csv"])), (written["rays_csv"], "data/ct/" + os.path.basename(
            written["rays_csv"])), (os.path.join(run_dir, "df-metrics.csv"),
                                    str(jax_run / "df-metrics.csv"))):
        assert _header(ws / port_csv) == _header(jax_ws / jax_csv)
        assert (len(open(ws / port_csv).readlines())
                == len(open(jax_ws / jax_csv).readlines()))
    assert result.iters_run == 30 and np.isfinite(result.best_heldout_psnr)
    assert len(tables[run_dir]["PSNR"]) == 9
    for root, want in ((ws, load_experiments_j(str(ws / "cases"))),
                       (jax_ws, load_experiments_j(str(jax_ws / "cases")))):
        _assert_table_is_frame(load_experiments(str(root / "cases")), want)
    assert list(loaded["run"]) == [os.path.basename(run_dir)]


def _assert_table_is_frame(table: dict, df: pd.DataFrame) -> None:
    """Column for column; a float within 1e-12 relative, since pandas'
    default CSV float parser can miss the written value by an ulp, where
    the port's parses it correctly rounded."""
    assert list(table) == list(df.columns)
    for c in df.columns:
        want = df[c].to_numpy()
        assert not isinstance(table[c], np.ndarray) or table[c].dtype == df[c].dtype, c
        if df[c].dtype.kind == "f":
            np.testing.assert_allclose(table[c], want, rtol=1e-12, atol=0, err_msg=c)
        elif df[c].dtype.kind == "b":
            np.testing.assert_array_equal(table[c], want, err_msg=c)
        else:
            assert list(table[c]) == list(want), c


@pytest.fixture
def cases(tmp_path):
    """A cases tree: three evaluated runs (one without readme.txt, one with
    NaN in a metric column), a run never evaluated and a data name without
    runs."""
    root = tmp_path / "cases"
    runs = {
        ("ct", "2026-01-01-0000"): ({"Limited projections": "180", "Sparse projections": "25",
                                     "Model architecture": "4x128", "Sampling": "Frangi",
                                     "Binary": "False"},
                                    {"PSNR": [20.5, 22.25], "SSIM": [0.9, np.nan],
                                     "DICE 2D": [0.5, 0.75]}),
        ("ct", "2026-01-01-0001"): ({"Limited projections": "90", "Sparse projections": "9",
                                     "Binary": "True"},
                                    {"PSNR": [30.0, 31.0, 29.0], "LPIPS": [0.1, 0.2, 0.3]}),
        ("LCA", "2026-01-02-0000"): (None, {"PSNR": [15.0], "DISTS": [0.4]}),
        ("LCA", "2026-01-02-0001"): ({"Limited projections": "25"}, None),
    }
    for (data, run), (meta, metrics) in runs.items():
        rd = root / data / "runs" / run
        rd.mkdir(parents=True)
        if meta is not None:
            (rd / "readme.txt").write_text("".join(f"{k}={v}\n" for k, v in meta.items()))
        if metrics is not None:
            write_csv_table({k: np.asarray(v) for k, v in metrics.items()},
                            str(rd / "df-metrics.csv"))
    (root / "sphere").mkdir()
    return str(root)


def test_load_experiments_matches_jax(cases, tmp_path):
    _assert_table_is_frame(load_experiments(cases), load_experiments_j(cases))
    assert load_experiments(str(tmp_path / "nothing")) == {}
    table = load_experiments(cases)
    first = table["run"].index("2026-01-01-0000")
    assert np.isnan(table["LPIPS mean"][first]) and table["SSIM mean"][first] == 0.9
    got = apply_filters(table, {"data_name": "ct", "Limited projections": (80.0, 100.0)})
    assert got["run"] == ["2026-01-01-0001"] and got["PSNR mean"].tolist() == [30.0]
    assert apply_filters(table, {"run": ["2026-01-02-0000"]})["data_name"] == ["LCA"]


def test_plot_is_drawn_with_matplotlib(cases, tmp_path):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "plot.png")
    plot_metric_vs_limited_angle(load_experiments(cases), out_path=out)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError, match="no data"):
        plot_metric_vs_limited_angle(load_experiments(cases), metric="DOT 2D")


def test_plot_without_matplotlib_names_it(cases, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plot_metric_vs_limited_angle(load_experiments(cases))
    table = load_experiments(cases)  # the loader needs no matplotlib
    assert len(table["run"]) == 3
