"""Port: evaluation and export against the JAX package on the same inputs
(numpy from a seed; CPPN weights, occupancy grids and perceptual weights
copied across).

Tolerances: exact for angles, file names, CSV headers and cells, Dice on
equal inputs, binarize, the heatmap JSON keys and angles, PNG pixels of the
same arrays, videos; ssim 1e-5 and dot_score 1e-6 on equal inputs; renders
(pixels in [0, 1]) within 2e-2, the port's render tolerance
(tests/test_torch_compact.py: the JAX package runs the flax MLP in bf16,
the port its fused MLP's plain version with f32 accumulation), and the
sweep's metrics within what that allows (PSNR 0.05 dB, SSIM / DOT / DICE
2D 5e-3, the 3D scores 2e-2). A batch of views equals the views rendered
alone bit for bit. The perceptual metrics are tests/test_torch_perceptual.py.
"""

import csv
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from nerf_for_angiography_tpu import evaluation as ej
from nerf_for_angiography_tpu.data import make_sphere_volume as make_sphere_volume_j
from nerf_for_angiography_tpu.evaluation import perceptual as pj
from nerf_for_angiography_tpu.evaluation import video as vj
from nerf_for_angiography_tpu.models import CPPN as CPPNJ
from nerf_for_angiography_tpu.models import CPPNConfig as CPPNConfigJ
from nerf_for_angiography_tpu.models import init_cppn
from nerf_for_angiography_tpu.ops import occupancy as oj
from nerf_for_angiography_tpu.ops.interpolation import trilinear as trilinear_j
from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ
from nerf_for_angiography_tpu.training import create_train_state as create_train_state_j
from nerf_for_angiography_tpu.training.train import render_rays_with_binary as render_binary_j
from nerf_for_angiography_tpu_torch import evaluation as et
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax, perceptual_params_from_jax
from nerf_for_angiography_tpu_torch.data import make_sphere_volume
from nerf_for_angiography_tpu_torch.evaluation import perceptual as pt
from nerf_for_angiography_tpu_torch.evaluation import sweep as st
from nerf_for_angiography_tpu_torch.evaluation import video as vt
from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig
from nerf_for_angiography_tpu_torch.ops import occupancy as ot
from nerf_for_angiography_tpu_torch.ops.interpolation import trilinear
from nerf_for_angiography_tpu_torch.ops.kernels import first_k as fk
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_for_angiography_tpu_torch.training import TrainConfig
from nerf_for_angiography_tpu_torch.training import render_rays_with_binary
from nerf_for_angiography_tpu_torch.utils import read_png_gray, write_png_gray
from test_webapp import _options_radio_values, js_build_url

PIX_ATOL = 2e-2  # renders: the port's render tolerance (bf16 flax vs f32-accumulated plain MLP)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# 1. metrics
# ---------------------------------------------------------------------------


def _images(seed=0, shape=(24, 20)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_mse_match_jax(seed):
    a, b = _images(seed)
    assert float(et.psnr(_t(a), _t(b))) == pytest.approx(float(ej.psnr(a, b)), rel=1e-6)
    assert float(et.mse(_t(a), _t(b))) == pytest.approx(float(ej.mse(a, b)), rel=1e-6)


@pytest.mark.parametrize("case", ["random", "constant_block", "near_constant", "identity"])
def test_ssim_matches_jax(case):
    a, b = _images(3)
    if case == "constant_block":
        a = np.ones((64, 64), np.float32)
        b = a.copy()
        b[30:34, 30:34] = 0.2
    elif case == "near_constant":
        a = np.ones((64, 64), np.float32)
        b = a * np.float32(0.9998)
    elif case == "identity":
        b = a
    got = float(et.ssim(_t(a), _t(b)))
    want = float(ej.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-5, (got, want)
    assert got <= 1.0 + 1e-6


def test_view_metrics_equal_one_view_metrics():
    """The (V, ...) forms the sweep scores a batch with give each view the
    value of the one-view function."""
    rng = np.random.default_rng(5)
    p = _t(rng.uniform(0, 1, (3, 16, 14)).astype(np.float32))
    q = _t(np.clip(p.numpy() + 0.05 * rng.standard_normal(p.shape), 0, 1).astype(np.float32))
    s = et.ssim(p, q)
    for v in range(3):
        assert float(s[v]) == pytest.approx(float(et.ssim(p[v], q[v])), abs=1e-6)
        assert float(et.metrics.psnr_views(p, q)[v]) == pytest.approx(float(et.psnr(p[v], q[v])),
                                                                     rel=1e-6)
        assert float(et.metrics.dot_score_views(p, q)[v]) == float(et.dot_score(p[v], q[v]))
        bp, bq = et.binarize(p, 0.5), et.binarize(q, 0.5)
        assert float(et.metrics.dice_micro_views(bp, bq)[v]) == float(et.dice_micro(bp[v], bq[v]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dice_binarize_dot_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 1.2, (20, 18)).astype(np.float32)
    b = rng.uniform(0.7, 1.2, (20, 18)).astype(np.float32)
    a[:3] = 1.0  # exactly at the threshold
    np.testing.assert_array_equal(et.binarize(_t(a)).numpy(), np.asarray(ej.binarize(a)))
    ba, bb = ej.binarize(a), ej.binarize(b)
    assert float(et.dice_micro(_t(ba), _t(bb))) == float(ej.dice_micro(ba, bb))
    assert float(et.dice_binary(_t(ba), _t(bb))) == float(ej.dice_binary(ba, bb))
    z = np.zeros_like(ba)
    assert float(et.dice_binary(_t(z), _t(z))) == float(ej.dice_binary(z, z)) == 1.0
    for norm in (True, False):
        got = float(et.dot_score(_t(a), _t(b), normalize=norm))
        assert abs(got - float(ej.dot_score(a, b, normalize=norm))) <= 1e-6
    # 3D, as the sweep scores the field
    f = rng.uniform(0, 1, (9, 9, 9)).astype(np.float32)
    g = rng.uniform(0, 1, (9, 9, 9)).astype(np.float32)
    assert abs(float(et.dot_score(_t(f), _t(g))) - float(ej.dot_score(f, g))) <= 1e-6
    thr = g.mean()
    assert float(et.dice_micro(_t(f >= thr), _t(g >= thr))) == float(
        ej.dice_micro(jnp.asarray(f >= thr), jnp.asarray(g >= thr)))


# ---------------------------------------------------------------------------
# 3. heatmap, PNG and video exports
# ---------------------------------------------------------------------------


def test_polar_hemisphere_naming_match_jax():
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-1, 1, 50), rng.uniform(-1, 1, 50)
    for a, b in zip(et.convert_to_polar(x, y), ej.convert_to_polar(x, y)):
        np.testing.assert_array_equal(a, b)
    th = rng.choice(np.arange(-180, 181, 10.0), 200)
    ph = rng.choice(np.arange(-180, 181, 10.0), 200)
    for pair in (("X", "Y"), ("X", "Z"), ("Y", "Z")):
        for name in ("top", "bottom"):
            np.testing.assert_array_equal(et.hemisphere_mask(th, ph, *pair, name),
                                          ej.hemisphere_mask(th, ph, *pair, name))
    with pytest.raises(ValueError):
        et.hemisphere_mask(th, ph, "X", "X", "top")
    pages = [{}, {"Category": ["Background"], "Sampling": ["Random sampling"], "Data": "LCA"},
             {"Category": ["Sparsity"], "Sampling": ["Segmentation sampling"],
              "Sparse projections": 49, "Limited projections": 90},
             {"Category": ["Limited projections", "Sparse projections"]},
             {"Category": ["Architecture"], "Model architecture": "2x64"}]
    for page in pages:
        for cp in ((90, 0), (90.0, 0.0), (45.5, -10.0)):
            assert et.experiment_naming(page, cp) == ej.experiment_naming(page, cp)
    np.testing.assert_array_equal(st.sweep_angles(et.EvalConfig()),
                                  ej.sweep_angles(ej.EvalConfig()))


def _synthetic_table(n=5, pixels=6, seed=0):
    th = np.repeat(np.linspace(0, 180, n), n)
    ph = np.tile(np.linspace(-90, 90, n), n)
    rng = np.random.RandomState(seed)
    return {
        "theta": th, "phi": ph,
        "cam_pose_x": (np.sin(np.deg2rad(th)) * np.cos(np.deg2rad(ph))).astype(np.float32),
        "cam_pose_y": (np.sin(np.deg2rad(th)) * np.sin(np.deg2rad(ph))).astype(np.float32),
        "cam_pose_z": np.cos(np.deg2rad(th)).astype(np.float32),
        "PSNR": rng.rand(n * n) * 30,
        "pred_img": rng.rand(n * n, pixels).astype(np.float32),
        "org_img": rng.rand(n * n, pixels).astype(np.float32),
    }


def _json_tree(root):
    out = {}
    for r, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(r, f)) as fh:
                out[os.path.relpath(os.path.join(r, f), root)] = json.load(fh)
    return out


@pytest.mark.parametrize("extra", [None, {"calibrated": False}])
def test_heatmap_jsons_match_jax(tmp_path, extra):
    table = _synthetic_table()
    df = pd.DataFrame({k: (list(v) if v.ndim == 2 else v) for k, v in table.items()})
    ej.normalize_cam_poses(df)
    et.normalize_cam_poses(table)
    for c in ("cam_pose_x", "cam_pose_y", "cam_pose_z"):
        np.testing.assert_array_equal(table[c], df[c].to_numpy(float))
    for name in ("top", "bottom"):
        oj_ = ej.get_2d_heatmap(df, str(tmp_path), str(tmp_path / "j"), name=name,
                                metric="PSNR", vminmax=(15, 50), save_png=False,
                                json_extra=extra)
        ot_ = et.get_2d_heatmap(table, str(tmp_path), str(tmp_path / "t"), name=name,
                                metric="PSNR", vminmax=(15, 50), save_png=False,
                                json_extra=extra)
        assert ot_ == oj_
    got, want = _json_tree(tmp_path / "t"), _json_tree(tmp_path / "j")
    assert set(got) == set(want) and len(got) > 2
    for k in want:
        assert got[k] == want[k], k


def test_png_writer_matches_pil(tmp_path):
    """The port's stdlib PNG writer against the JAX sweep's PIL writer on the
    same arrays: PIL decodes both to the same pixels."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for shape in ((12, 12), (162, 150), (1, 7)):
        img = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
        arr = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        Image.fromarray(arr, mode="L").save(tmp_path / "pil.png")
        write_png_gray(str(tmp_path / "port.png"), arr)
        a = np.asarray(Image.open(tmp_path / "pil.png"))
        b = np.asarray(Image.open(tmp_path / "port.png"))
        assert Image.open(tmp_path / "port.png").mode == "L"
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(read_png_gray(str(tmp_path / "port.png")), arr)
    with pytest.raises(ValueError):
        write_png_gray(str(tmp_path / "bad.png"), np.zeros((2, 2, 3), np.uint8))


def test_videos_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    rows = [{"org_img": rng.rand(80), "pred_img": rng.rand(80),
             "binary_pred_img": rng.rand(80)} for _ in range(4)]
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    wj = vj.get_videos(rows, "theta-rotation", 8, 10, str(tmp_path / "j"))
    wt = vt.get_videos(rows, "theta-rotation", 8, 10, str(tmp_path / "t"))
    assert [os.path.basename(p) for p in wt] == [os.path.basename(p) for p in wj]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for f in os.listdir(tmp_path / "j"):
        assert open(tmp_path / "t" / f, "rb").read() == open(tmp_path / "j" / f, "rb").read(), f
    frames = [(rng.rand(10, 12) * 255).astype(np.uint8) for _ in range(3)]
    vt._mjpeg_avi(frames, str(tmp_path / "t.avi"), 10)
    vj._mjpeg_avi(frames, str(tmp_path / "j.avi"), 10)
    assert open(tmp_path / "t.avi", "rb").read() == open(tmp_path / "j.avi", "rb").read()


# ---------------------------------------------------------------------------
# 4-5. render_rays_with_binary, render_view_pair, batches
# ---------------------------------------------------------------------------

OUTSIDE = 100.0


def _blob_binary(res, seed=1):
    rng = np.random.default_rng(seed)
    idx = np.stack(np.meshgrid(*[np.arange(res) + 0.5] * 3, indexing="ij"), -1)
    binary = np.zeros((res,) * 3, bool)
    for _ in range(6):
        c = rng.uniform(0.2, 0.8, 3) * res
        r = rng.uniform(0.1, 0.2) * res
        binary |= ((idx - c) ** 2).sum(-1) < r * r
    return binary


def _grid_pair(res=16, outside=OUTSIDE):
    b = _blob_binary(res)
    aabb = [-outside] * 3 + [outside] * 3
    gj = oj.with_packed(oj.OccupancyGrid(
        occs=jnp.zeros((res,) * 3, jnp.float32), binary=jnp.asarray(b),
        aabb=jnp.asarray(aabb, jnp.float32)))
    return gj, ot.grid_from_numpy(b, aabb)


def _model_pair(outside=OUTSIDE, bias=-5.0, gain=4.0, seed=3):
    """A 2x32 CPPN in both packages with the same weights; the head is
    shifted and scaled so the densities span the binary threshold and the
    renders are neither black nor white."""
    kw = dict(num_early_layers=2, num_filters=32, input_scale=1.0 / outside)
    model_j, params = init_cppn(CPPNConfigJ(**kw, dtype=jnp.bfloat16), jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    params["params"]["output_linear"]["kernel"] = params["params"]["output_linear"]["kernel"] * gain
    params["params"]["output_linear"]["bias"] = params["params"]["output_linear"]["bias"] + bias
    model_t = CPPN(CPPNConfig(**kw, dtype=torch.bfloat16))
    model_t.load_state_dict(cppn_params_from_jax(params))
    return model_j, jax.tree.map(jnp.asarray, params), model_t


def _rays(n=96, seed=0, z=1500.0):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-20, 20, (n, 2))
    o[:, 2] = z
    target = rng.uniform(-90, 90, (n, 3)).astype(np.float32)
    target[:, 2] = 0.0
    return o, ((target - o) / z).astype(np.float32)


MARCHES = {
    "dense": dict(compact_samples=0),
    "lattice": dict(compact_samples=48, march_mode="lattice"),
    "hybrid2k": dict(compact_samples=40, march_mode="hybrid", hybrid_w_cap=64, hybrid_w_lo=32,
                     hybrid_split=0.75, hybrid_bucket_k=True, hybrid_k_lo=16),
}


@pytest.mark.parametrize("march", sorted(MARCHES))
def test_render_rays_with_binary_matches_jax(march):
    kw = dict(depth_samples_per_ray=96, grid_resolution=16, outside=OUTSIDE, alpha_thre=1e-4,
              early_stop_eps=1e-2, **MARCHES[march])
    gj, gt = _grid_pair()
    model_j, params, model_t = _model_pair()
    o, d = _rays()
    near, far = 1500.0 - 75.0, 1500.0 + 75.0
    pj_, bj = render_binary_j(model_j, params, gj, jnp.asarray(o), jnp.asarray(d),
                              TrainConfigJ(**kw), near, far, binary_thresh=0.05)
    with torch.no_grad():
        pt_, bt = render_rays_with_binary(model_t, gt, _t(o), _t(d), TrainConfig(**kw), near,
                                          far, binary_thresh=0.05)
    pj_, bj = np.asarray(pj_), np.asarray(bj)
    assert 0.05 < pj_.mean() < 0.95 and (bj > pj_ + 1e-3).any()  # neither black nor white
    np.testing.assert_allclose(pt_.numpy(), pj_, atol=PIX_ATOL)
    np.testing.assert_allclose(bt.numpy(), bj, atol=PIX_ATOL)
    assert (bt >= pt_ - 1e-6).all()


def _ct_cfg(**kw):
    return et.EvalConfig(img_width=12, img_height=10, depth_samples_per_ray=kw.pop("depth", 128),
                         **kw)


def _lca_cfg(**kw):
    return et.lca_eval_config(img_width=8, img_height=10, depth_samples_per_ray=24,
                              sample_outside=50.0, **kw)


@pytest.mark.parametrize("branch", ["ct", "ct_dense", "lca"])
def test_render_view_pair_matches_jax(branch):
    """ct: compacted lattice march (k = 96 of 128 samples) and the dense one
    (32 samples); LCA: the dense MLP render. Weights and grid copied."""
    if branch == "lca":
        cfg_t = _lca_cfg()
        cfg_j = ej.lca_eval_config(img_width=8, img_height=10, depth_samples_per_ray=24,
                                   sample_outside=50.0)
        model_j, params, model_t = _model_pair(outside=80.0, bias=-26.0, gain=20.0)
        gj, gt = _grid_pair(outside=80.0)
    else:
        depth = 128 if branch == "ct" else 32
        cfg_t = _ct_cfg(depth=depth)
        cfg_j = ej.EvalConfig(img_width=12, img_height=10, depth_samples_per_ray=depth)
        model_j, params, model_t = _model_pair()
        gj, gt = _grid_pair()
    fk.reset_counts()
    fm.reset_counts()
    for theta, phi in ((30.0, 45.0), (300.0, 0.0)):
        pj_, bj, cj = ej.render_view_pair(model_j, params, gj, cfg_j, theta, phi)
        pt_, bt, ct = et.render_view_pair(model_t, gt, cfg_t, theta, phi, device="cpu")
        assert pt_.shape == pj_.shape == (cfg_t.img_height, cfg_t.img_width)
        assert 0.02 < pj_.mean() < 0.98, pj_.mean()
        np.testing.assert_allclose(pt_, pj_, atol=PIX_ATOL)
        np.testing.assert_allclose(bt, bj, atol=PIX_ATOL)
        np.testing.assert_allclose(ct, cj, rtol=1e-6, atol=1e-3)
    assert fk.launches == 0 and fm.fwd_launches == 0  # plain versions on the CPU


@pytest.mark.parametrize("branch", ["ct", "lca"])
def test_batch_of_four_views_equals_four_single_views(branch):
    """The batch renderer's one march and one MLP call over four views'
    rays equals four one-view renders bit for bit (everything works per
    ray or per point), as the JAX package's vmap over views does."""
    if branch == "lca":
        cfg = _lca_cfg()
        _, _, model = _model_pair(outside=80.0, bias=-26.0, gain=20.0)
        _, grid = _grid_pair(outside=80.0)
    else:
        cfg = _ct_cfg()
        _, _, model = _model_pair()
        _, grid = _grid_pair()
    angles = np.array([[30.0, 45.0], [-60.0, 10.0], [0.0, 0.0], [170.0, -90.0]])
    batch = et.make_batch_view_renderer(model, grid, cfg)
    single = et.make_view_renderer(model, grid, cfg)
    t360, p360 = st._angles_360(angles)
    px, bpx, c2w = batch(grid, t360, p360)
    for k in range(4):
        p1, b1, c1 = single(grid, t360[k], p360[k])
        assert torch.equal(px[k], p1) and torch.equal(bpx[k], b1) and torch.equal(c2w[k], c1)
    views = et.render_sweep_views(model, grid, cfg, angles[:3], device="cpu")
    assert len(views) == 3  # a padded batch of 4, one view dropped
    for k, (p, b, c) in enumerate(views):
        np.testing.assert_array_equal(p, px[k].numpy().reshape(10, -1))


class _TwoRankMesh:
    """A mesh's shape as the sweep reads it: rank 0 of 2."""

    def get_local_rank(self):
        return 0

    def size(self):
        return 2


def test_mesh_and_device_are_refused():
    _, _, model = _model_pair()
    _, grid = _grid_pair()
    # a batch of views that does not divide over the mesh's ranks
    renderer = et.make_batch_view_renderer(model, grid, _ct_cfg(), mesh=_TwoRankMesh())
    with pytest.raises(ValueError, match="do not divide"):
        renderer(grid, [0.0, 10.0, 20.0], [0.0, 0.0, 0.0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            et.run_sweep(model, grid, _ct_cfg(), None, "unused")
        with pytest.raises(RuntimeError, match="CUDA"):
            et.render_view_pair(model, grid, _ct_cfg(), 0.0, 0.0)
        with pytest.raises(RuntimeError, match="CUDA"):
            et.export_field_vtk(model, _ct_cfg(), "unused.vtk")


# ---------------------------------------------------------------------------
# 6-7. run_sweep end to end, cag-vis radios
# ---------------------------------------------------------------------------

PAGE = {
    "Category": ["Background"], "Sampling": ["Frangi sampling", "AccNeRF"],
    "Model architecture": "4x128", "Sparse projections": 25, "Limited projections": 180,
    "Data": "CT",
}


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """tests/test_evaluation.py::test_sweep_uncalibrated_perceptual_exports'
    sweep in both packages: sphere volume at res 24, 12x12 images, a 3x3
    sweep, field 9^3, the JAX state's weights and grid and the uncalibrated
    perceptual weights copied across."""
    root = tmp_path_factory.mktemp("sweeps")
    vol_j = make_sphere_volume_j(res=24, extent=75.0, radius=30.0, mu=0.02)
    vol_t = make_sphere_volume(res=24, extent=75.0, radius=30.0, mu=0.02)
    tcfg = TrainConfigJ(depth_samples_per_ray=32, sample_size=8, grid_resolution=8, n_iters=1,
                        display_every=1)
    model_j, state = create_train_state_j(tcfg, jax.random.PRNGKey(0))
    kw = dict(limited_size_vis=180.0, number_angles_vis=2.0, img_width=12, img_height=12,
              sample_outside=100.0, depth_samples_per_ray=32, outside=100.0,
              field_resolution=9, save_videos=True)
    cfg_j, cfg_t = ej.EvalConfig(**kw), et.EvalConfig(**kw)
    pm_j = pj.PerceptualMetrics.uncalibrated(jax.random.PRNGKey(0))
    pm_t = pt.PerceptualMetrics(**perceptual_params_from_jax(
        [(np.asarray(w), np.asarray(b)) for w, b in pm_j.vgg_params],
        [np.asarray(w) for w in pm_j.lpips_weights],
        [np.asarray(a) for a in pm_j.dists_alpha], [np.asarray(b) for b in pm_j.dists_beta]),
        calibrated=False)
    params = jax.tree.map(np.asarray, state.params)
    model_t = CPPN(TrainConfig(**{k: getattr(tcfg, k) for k in (
        "depth_samples_per_ray", "grid_resolution")}).model_config())
    model_t.load_state_dict(cppn_params_from_jax(params))
    grid_t = ot.grid_from_numpy(np.asarray(state.grid.binary), np.asarray(state.grid.aabb),
                                occs=np.asarray(state.grid.occs))
    out_j, out_t = str(root / "jax"), str(root / "port")
    df = ej.run_sweep(model_j, state.params, state.grid, cfg_j, ej.gt_from_volume(vol_j, cfg_j),
                      out_j, page_data=PAGE, perceptual=pm_j,
                      gt_volume_sampler=lambda p: trilinear_j(vol_j, p), verbose=False)
    timing = {}
    fk.reset_counts()
    fm.reset_counts()
    table = et.run_sweep(model_t, grid_t, cfg_t, et.gt_from_volume(vol_t, cfg_t), out_t,
                         page_data=PAGE, perceptual=pm_t,
                         gt_volume_sampler=lambda p: trilinear(vol_t, p), verbose=False,
                         device="cpu", timing=timing)
    launches = (fk.launches, fm.fwd_launches)
    return dict(df=df, table=table, out_j=out_j, out_t=out_t, timing=timing,
                launches=launches, cfg=cfg_t, model=model_t, params=params)


def _files(root):
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _, fs in os.walk(root) for f in fs)


def test_sweep_writes_the_jax_files(sweeps):
    assert _files(sweeps["out_t"]) == _files(sweeps["out_j"])
    assert sweeps["launches"] == (0, 0)
    assert set(sweeps["timing"]) == {"render", "gt", "metrics", "perceptual", "png", "vtk",
                                     "csv", "video", "json"}


def test_sweep_csv_matches_jax(sweeps):
    """df-metrics.csv read back with pandas: the same header and column
    order, angles and ids exactly, the rest within the stated bounds."""
    path_j = os.path.join(sweeps["out_j"], "df-metrics.csv")
    path_t = os.path.join(sweeps["out_t"], "df-metrics.csv")
    head_j = open(path_j).readline()
    assert open(path_t).readline() == head_j
    mj = pd.read_csv(path_j, sep=";", index_col=0)
    mt = pd.read_csv(path_t, sep=";", index_col=0)
    assert list(mt.columns) == list(mj.columns)
    assert list(mt.index) == list(mj.index) == list(range(9))
    for c in ("image_id", "theta", "phi", "larm", "theta_360", "phi_360",
              "perceptual_calibrated"):
        assert list(mt[c]) == list(mj[c]), c
    for c in ("cam_pose_x", "cam_pose_y", "cam_pose_z"):
        np.testing.assert_allclose(mt[c], mj[c], atol=1e-3)
    # the images these come from agree within PIX_ATOL; at 12x12 the
    # perceptual columns are NaN in both packages
    np.testing.assert_allclose(mt["PSNR"], mj["PSNR"], atol=0.05)
    for c in ("SSIM", "DOT 2D", "DICE 2D"):
        np.testing.assert_allclose(mt[c], mj[c], atol=5e-3)
    for c in ("LPIPS", "DISTS"):
        assert mt[c].isna().all() and mj[c].isna().all()
    for c in ("DICE 3D", "DOT 3D"):
        np.testing.assert_allclose(mt[c], mj[c], atol=2e-2)
    # the table the port returns holds the DataFrame's columns in its order
    assert list(sweeps["table"]) == list(sweeps["df"].columns)
    for c in ("pred_img", "binary_pred_img", "org_img"):
        want = np.array(sweeps["df"][c].tolist(), np.float32)
        np.testing.assert_allclose(sweeps["table"][c], want,
                                   atol=1e-5 if c == "org_img" else PIX_ATOL)


def test_sweep_summary_pngs_vtk_and_jsons_match_jax(sweeps):
    from PIL import Image

    from nerf_for_angiography_tpu_torch.utils import read_vtk

    def summary(root):
        lines = open(os.path.join(root, "metrics-summary.txt")).read().splitlines()
        return dict(ln.split("=", 1) for ln in lines)

    sj, stt = summary(sweeps["out_j"]), summary(sweeps["out_t"])
    assert list(stt) == list(sj)
    for k in sj:
        a, b = float(stt[k]), float(sj[k])
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= (0.05 if "PSNR" in k else 2e-2), k
    proj = [f for f in _files(sweeps["out_t"]) if f.endswith(".png")]
    assert len(proj) == 18
    for f in proj:
        a = np.asarray(Image.open(os.path.join(sweeps["out_t"], f)), np.int32)
        b = np.asarray(Image.open(os.path.join(sweeps["out_j"], f)), np.int32)
        assert np.abs(a - b).max() <= 6, f  # 2e-2 of 255, plus one for the truncation
    gt_, gj = (read_vtk(os.path.join(r, "coarse-field.vtk")) for r in (sweeps["out_t"],
                                                                     sweeps["out_j"]))
    assert gt_.dimensions == gj.dimensions == (9, 9, 9)
    np.testing.assert_array_equal(gt_.points, gj.points)
    np.testing.assert_allclose(gt_.point_data["scalars"], gj.point_data["scalars"], atol=2e-2)
    tj, tt = (_json_tree(os.path.join(r, "jsonData")) for r in (sweeps["out_j"],
                                                                sweeps["out_t"]))
    assert set(tt) == set(tj)
    for k, want in tj.items():
        got = tt[k]
        assert set(got) == set(want), k
        if "angles" in want:
            assert got["angles"] == want["angles"] and got["rad"] == want["rad"], k
            assert got.get("calibrated") == want.get("calibrated"), k
        else:
            np.testing.assert_allclose(got["org"], want["org"], atol=1e-5)
            np.testing.assert_allclose(got["pred"], want["pred"], atol=PIX_ATOL)


def test_sweep_table_feeds_the_heatmap_export_again(sweeps, tmp_path):
    """export_heatmaps (the sweep's heatmap block) writes each per-angle
    file once with the JSONs get_2d_heatmap writes for every metric."""
    table = {k: (v.copy() if hasattr(v, "copy") else v) for k, v in sweeps["table"].items()}
    cfg = sweeps["cfg"]
    done = st.export_heatmaps(table, cfg, str(tmp_path / "a"), PAGE, save_png=False)
    assert done == ["PSNR", "SSIM", "DICE 2D", "DOT 2D", "LPIPS", "DISTS"]
    got = _json_tree(tmp_path / "a" / "jsonData")
    want = _json_tree(os.path.join(sweeps["out_t"], "jsonData"))
    # without the perceptual backend passed, no calibrated flag is added
    for k in want:
        if "calibrated" in want[k]:
            want[k] = {q: v for q, v in want[k].items() if q != "calibrated"}
    assert got == want


def test_every_metric_radio_resolves_against_the_port_export(sweeps):
    """Every metric/direction radio of cag_vis/options.js resolves to a JSON
    the port's sweep wrote (tests/test_webapp.py's check for JAX)."""
    root = os.path.join(sweeps["out_t"], "jsonData")
    state_js = {
        "metric": "PSNR", "direction": "top", "centerPoint": "[90, 0]",
        "limitedAngle": 180, "sparseAngle": 25, "firstAxis": "X",
        "secondAxis": "Z", "sparsity": "ct", "background": "background",
        "samplingStrategy": "", "architecture": "4x128",
    }
    metrics = _options_radio_values("metric")
    assert metrics
    for metric in metrics:
        for direction in _options_radio_values("direction"):
            rel = js_build_url({**state_js, "metric": metric, "direction": direction})
            assert os.path.exists(os.path.join(root, rel)), rel


def test_export_field_vtk_matches_jax(tmp_path, sweeps):
    from nerf_for_angiography_tpu_torch.utils import read_vtk

    cfg = sweeps["cfg"]
    model_j = CPPNJ(TrainConfigJ(depth_samples_per_ray=32, grid_resolution=8).model_config())
    want = ej.export_field_vtk(model_j, jax.tree.map(jnp.asarray, sweeps["params"]),
                               ej.EvalConfig(field_resolution=9), str(tmp_path / "j.vtk"),
                               chunk=100)
    fm.reset_counts()
    got = et.export_field_vtk(sweeps["model"], cfg, str(tmp_path / "t.vtk"), chunk=100,
                              device="cpu")
    np.testing.assert_allclose(got, want, atol=2e-2)
    g = read_vtk(str(tmp_path / "t.vtk"))
    np.testing.assert_array_equal(g.scalars_3d(), got)
    assert open(tmp_path / "t.vtk", "rb").read(200) == open(tmp_path / "j.vtk", "rb").read(200)


def test_csv_cells_are_the_pandas_cells(tmp_path):
    """write_metrics_csv against pandas' to_csv on the same column table."""
    table = {
        "image_id": np.array(["-90,0-0,0", "0,0-90,0"], dtype=object),
        "theta": np.array([-90.0, 0.0]), "larm": np.zeros(2, np.int64),
        "cam_pose_x": np.array([0.1, -1499.9999], np.float32),
        "PSNR": np.array([23.456789012345, 1e-5]),
        "pred_img": np.zeros((2, 4), np.float32),
        "DICE 3D": np.full(2, float(np.float32(0.9))),
        "perceptual_calibrated": np.full(2, False),
    }
    st.write_metrics_csv(table, str(tmp_path / "t.csv"))
    df = pd.DataFrame({k: v for k, v in table.items() if k != "pred_img"})
    buf = io.StringIO()
    df.to_csv(buf, sep=";")
    assert open(tmp_path / "t.csv").read() == buf.getvalue()
    rows = list(csv.reader(open(tmp_path / "t.csv"), delimiter=";"))
    assert rows[0][0] == "" and len(rows) == 3
