"""Port: the SDF/LCA datagen against the JAX package: the transfer
functions, the LCA SDF phantom, the closed-form sphere pixel, the SDF angle
grid and preset, SDF DRRs, the LCA dataset, the CSV round trip the JAX LCA
anchor trained through, and a tiny LCA train() on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.data import generate_dataset as generate_dataset_j
from nerf_for_angiography_tpu.data import load_data as load_data_j
from nerf_for_angiography_tpu.data import make_lca_sdf_volume as make_lca_sdf_volume_j
from nerf_for_angiography_tpu.data import rev_sigmoid as rev_sigmoid_j
from nerf_for_angiography_tpu.data import sphere_line_integral as sphere_line_integral_j
from nerf_for_angiography_tpu.data import transfer_func_ct as transfer_func_ct_j
from nerf_for_angiography_tpu.data import write_proj_csv as write_proj_csv_j
from nerf_for_angiography_tpu.data import write_rays_csv as write_rays_csv_j
from nerf_for_angiography_tpu.data.datasets import sdf_angle_grid as sdf_angle_grid_j
from nerf_for_angiography_tpu.data.datasets import sdf_datagen_config as sdf_datagen_config_j
from nerf_for_angiography_tpu.data.drr import render_drr as render_drr_j
from nerf_for_angiography_tpu.geometry import get_ray_values as get_ray_values_j
from nerf_for_angiography_tpu.geometry import linspace_depths as linspace_j
from nerf_for_angiography_tpu_torch.data import (
    generate_dataset,
    make_lca_sdf_volume,
    render_drr,
    rev_sigmoid,
    sphere_line_integral,
    transfer_func_ct,
)
from nerf_for_angiography_tpu_torch.data.datasets import sdf_angle_grid, sdf_datagen_config
from nerf_for_angiography_tpu_torch.ops.interpolation import RegularGrid
from nerf_for_angiography_tpu_torch.training import TrainConfig, lca_protocol, train

# the small LCA sweep: 26 views of 20 x 18 pixels, 200 depths a ray
SMALL_LCA = dict(img_width=20, img_height=18, sample_outside=100.0, stratified_depths=False)
BREAKPOINTS = (0.0, 753.0, 1585.85, 2332.9, 3306.18, 4000.0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("binary", [False, True])
def test_transfer_func_ct_matches_jax(binary):
    """Every breakpoint, values below 0 and above 4000, and seeded values
    across the range: within 1e-6."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        np.asarray(BREAKPOINTS, np.float32), [-1e6, -500.0, -1e-3, 4000.001, 4500.0, 1e7],
        rng.uniform(-200.0, 4200.0, 2000),
    ]).astype(np.float32)
    want = np.asarray(transfer_func_ct_j(jnp.asarray(vals), binary=binary))
    got = transfer_func_ct(vals, binary=binary).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("c1,c2", [(1.0, 0.0), (2.0, 0.0), (2.0, 1.5)])
def test_rev_sigmoid_matches_jax(c1, c2):
    """Including +-200, where exp overflows to inf (the result is 0) or
    underflows to 0 (the result is 1): within 1e-6."""
    x = np.concatenate([[-200.0, 200.0, -80.0, 80.0, 0.0],
                        np.random.default_rng(1).normal(0.0, 5.0, 1000)]).astype(np.float32)
    want = np.asarray(rev_sigmoid_j(jnp.asarray(x), c1=c1, c2=c2))
    got = rev_sigmoid(x, c1=c1, c2=c2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[1] == 0.0 and got[0] == 1.0


def test_lca_sdf_volume_matches_jax():
    vj, vt = make_lca_sdf_volume_j(res=24), make_lca_sdf_volume(res=24)
    np.testing.assert_allclose(vt.values.numpy(), np.asarray(vj.values), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(vt.origin.numpy(), np.asarray(vj.origin))
    np.testing.assert_array_equal(vt.spacing.numpy(), np.asarray(vj.spacing))
    np.testing.assert_array_equal(vt.fill_value.numpy(), np.asarray(vj.fill_value))
    assert vt.values.shape == (24, 24, 24)


def test_sphere_line_integral_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(50):
        o = rng.normal(0.0, 40.0, 3)
        d = rng.normal(0.0, 1.0, 3)
        assert sphere_line_integral(o, d, 30.0, 0.02) == sphere_line_integral_j(o, d, 30.0, 0.02)
    assert sphere_line_integral(np.array([0.0, 0.0, 100.0]), np.array([0.0, 1.0, 0.0]),
                                30.0, 0.02) == 1.0


def test_sdf_angle_grid_and_preset_match_jax():
    for limited, n in ((25.0, 4.0), (90.0, 3.0), (40.0, 8.0)):
        np.testing.assert_array_equal(sdf_angle_grid(limited, n), sdf_angle_grid_j(limited, n))
    assert sdf_angle_grid(25.0, 4.0).shape == (26, 2)
    cj, ct = sdf_datagen_config_j(), sdf_datagen_config()
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    for prop in ("near_thresh", "far_thresh", "depth_samples_per_ray"):
        assert getattr(ct, prop) == getattr(cj, prop)
    np.testing.assert_array_equal(ct.src_pt, cj.src_pt)
    assert dataclasses.asdict(sdf_datagen_config(img_width=20)) == dataclasses.asdict(
        sdf_datagen_config_j(img_width=20))


@pytest.mark.parametrize("theta,phi", [(6.25, 12.5), (25.0, 0.0), (112.5, 112.5)])
def test_sdf_render_drr_matches_jax(theta, phi):
    """mode='sdf' on the same volume, rays and depths: within 1e-6. The
    query points take one rounding (addcmul), as the compiled JAX DRR's
    fused multiply-add does; with two roundings these views differed by
    up to 1.6e-5 at the 4000-unit source distance."""
    cfg = sdf_datagen_config(**SMALL_LCA)
    vol_j = make_lca_sdf_volume_j(res=24)
    vol_t = RegularGrid(*(_t(a) for a in vol_j))
    oj, dj, _ = get_ray_values_j(theta, phi, 0.0, cfg.src_pt, 20, 18, cfg.focal_length)
    zj = linspace_j(cfg.near_thresh, cfg.far_thresh, cfg.depth_samples_per_ray)
    want = np.asarray(render_drr_j(vol_j, oj, dj, zj, "sdf"))
    got = render_drr(vol_t, _t(oj), _t(dj), _t(zj), "sdf").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert want.min() < 0.5 < want.max()  # the tree is in view


@pytest.fixture(scope="module")
def lca_pair():
    """The small LCA dataset from both packages, with and without
    per_image_normalize."""
    out = {}
    for pin in (True, False):
        kw = dict(SMALL_LCA, per_image_normalize=pin)
        out[pin] = (
            generate_dataset_j(make_lca_sdf_volume_j(res=24), sdf_datagen_config_j(**kw)),
            generate_dataset(make_lca_sdf_volume(res=24), sdf_datagen_config(**kw), device="cpu"),
        )
    return out


@pytest.mark.parametrize("per_image_normalize", [True, False])
def test_lca_dataset_matches_jax(lca_pair, per_image_normalize):
    """Images and pixel values within 5e-5, rays within rtol 1e-5, weight
    maps within 1e-5, ids and positions exact. The images' limit is the
    views at 25 degrees: there the two packages' f32 pose math puts the
    source 1 ulp apart (2.4e-4 at z = 4000), which moves their pixels by up
    to 2.7e-5; at every other view they agree within 1.2e-7."""
    ds_j, ds_t = lca_pair[per_image_normalize]
    np.testing.assert_array_equal(ds_t.angles, ds_j.angles)
    assert ds_t.images.shape == (26, 18, 20)
    np.testing.assert_allclose(ds_t.images, ds_j.images, rtol=0, atol=5e-5)
    np.testing.assert_allclose(ds_t.weight_maps, ds_j.weight_maps, rtol=0, atol=1e-5)
    r_j, r_t = ds_j.rays, ds_t.rays
    np.testing.assert_allclose(r_t.pixel_values.numpy(), np.asarray(r_j.pixel_values), rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(r_t.weights.numpy(), np.asarray(r_j.weights), rtol=0, atol=1e-5)
    np.testing.assert_allclose(r_t.origins.numpy(), np.asarray(r_j.origins), rtol=1e-5, atol=0)
    np.testing.assert_allclose(r_t.directions.numpy(), np.asarray(r_j.directions), rtol=1e-5,
                               atol=1e-6)
    for name in ("image_ids", "x_positions", "y_positions"):
        np.testing.assert_array_equal(getattr(r_t, name).numpy(), np.asarray(getattr(r_j, name)))
    # every view but the 25-degree ones within 2e-7
    far = (ds_j.angles == 25.0).any(axis=1)
    np.testing.assert_allclose(ds_t.images[~far], ds_j.images[~far], rtol=0, atol=2e-7)


def test_per_image_normalize_spans_each_view(lca_pair):
    """sdftoray.py:125-127 normalizes each view before the joint
    normalization: with it, every view reaches 0 and 1 up to the joint
    rescale; the JAX images say the same."""
    for ds in lca_pair[True]:
        assert np.allclose(ds.images.reshape(26, -1).max(axis=1), 1.0, atol=1e-6)
        assert np.allclose(ds.images.reshape(26, -1).min(axis=1), 0.0, atol=1e-6)


def test_identity_resize_is_a_no_op_in_both(lca_pair):
    """resize_to = (H, W): the JAX package's linear jax.image.resize at
    identity scale returns its input up to one rounding (relative 1e-7),
    and the port skips it (bit for bit the dataset without it)."""
    ds_j, ds_t = lca_pair[True]
    kw = dict(SMALL_LCA, resize_to=(18, 20))
    rj = generate_dataset_j(make_lca_sdf_volume_j(res=24), sdf_datagen_config_j(**kw))
    rt = generate_dataset(make_lca_sdf_volume(res=24), sdf_datagen_config(**kw), device="cpu")
    np.testing.assert_allclose(rj.images, ds_j.images, rtol=1e-7, atol=0)
    np.testing.assert_allclose(rj.weight_maps, ds_j.weight_maps, rtol=1e-7, atol=0)
    np.testing.assert_array_equal(rt.images, ds_t.images)
    np.testing.assert_array_equal(rt.weight_maps, ds_t.weight_maps)
    img = np.random.default_rng(3).uniform(0.0, 1.0, (18, 20)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jax.image.resize(jnp.asarray(img), (18, 20), "linear")), img, rtol=1e-7,
        atol=0)


def test_non_identity_resize_raises_in_both():
    kw = dict(SMALL_LCA, resize_to=(9, 10))
    with pytest.raises(ValueError, match="resize_to"):
        generate_dataset_j(make_lca_sdf_volume_j(res=8), sdf_datagen_config_j(**kw))
    with pytest.raises(ValueError, match="resize_to"):
        generate_dataset(make_lca_sdf_volume(res=8), sdf_datagen_config(**kw), device="cpu")


def test_csv_round_trip_keeps_f32_rays_exact(lca_pair, tmp_path):
    """The JAX LCA anchor trained on the CSV round trip (cli/train.py:33-39,
    load_data's f32 casts); the port trains on the in-memory dataset. The
    round trip returns every ray array bit for bit, with the pandas and the
    default loader, so the two are the same input."""
    ds_j, _ = lca_pair[True]
    proj, rays = str(tmp_path / "df-sdftoproj.csv"), str(tmp_path / "df-rays.csv")
    write_proj_csv_j(ds_j, proj)
    write_rays_csv_j(ds_j, rays)
    for native in (False, True):
        loaded = load_data_j(proj, rays, use_native=native)
        assert loaded.src_pt_z == 4000.0 and loaded.rays_per_view == 18 * 20
        for name in ("origins", "directions", "pixel_values", "weights", "image_ids",
                     "x_positions", "y_positions"):
            got, want = np.asarray(getattr(loaded.rays, name)), np.asarray(getattr(ds_j.rays, name))
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_stratified_sweep_is_the_same_every_call():
    """Without a key the JAX sweep draws its stratified depths from
    PRNGKey(0), so two calls give the same dataset; without a generator
    the port's draws from one seeded with 0, whatever the global RNG holds
    (an unseeded draw gave each process another LCA dataset). A generator
    passed in still sets the draw."""
    kw = dict(SMALL_LCA, stratified_depths=True)
    vol_j, vol_t = make_lca_sdf_volume_j(res=24), make_lca_sdf_volume(res=24)
    a_j, b_j = (generate_dataset_j(vol_j, sdf_datagen_config_j(**kw)) for _ in range(2))
    np.testing.assert_array_equal(np.asarray(a_j.images), np.asarray(b_j.images))
    a = generate_dataset(vol_t, sdf_datagen_config(**kw), device="cpu")
    torch.rand(1000)
    b = generate_dataset(vol_t, sdf_datagen_config(**kw), device="cpu")
    np.testing.assert_array_equal(a.images, b.images)
    assert torch.equal(a.rays.pixel_values, b.rays.pixel_values)
    c = generate_dataset(vol_t, sdf_datagen_config(**kw),
                         generator=torch.Generator().manual_seed(1), device="cpu")
    assert not np.array_equal(a.images, c.images)


def test_lca_protocol_is_the_anchors_configuration():
    """lca_protocol gives the TrainConfig the JAX LCA anchor trained with
    (cli/train.py --data_name LCA --display_every 1000 --compact_engage_max
    192), overrides on top, and the source distance of the JAX SDF preset."""
    from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ

    cfg, src_z = lca_protocol(n_iters=7, seed=3)
    want = TrainConfigJ(compact_engage_max=192, display_every=1000, data_name="LCA", n_iters=7,
                        seed=3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.save_every == want.save_every == 100_000
    assert src_z == float(np.asarray(sdf_datagen_config_j().src_pt)[2]) == 4000.0


def test_tiny_lca_train_runs_on_cpu(lca_pair):
    """A tiny LCA train() (source at z = 4000, the held-out custom view) on
    the port's small dataset runs to its end with finite PSNRs."""
    _, ds_t = lca_pair[True]
    cfg = TrainConfig(sample_size=8, depth_samples_per_ray=32, grid_resolution=16, num_layers=2,
                      num_hidden_units=32, sampling_strategy="segmentation", coarse_lr=1e-3,
                      n_iters=12, display_every=6, data_name="LCA")
    res = train(cfg, ds_t.rays, src_pt_z=4000.0, verbose=False, device="cpu")
    assert res.iters_run == 12 and res.state.step == 13
    assert np.isfinite(res.best_heldout_psnr) and np.isfinite(res.last_psnr)
    assert res.page_data["Data"] == "LCA"


@pytest.mark.parametrize("march", ["lattice", "hybrid2k", "dense"])
def test_lca_geometry_step_matches_jax(march):
    """One train step at the LCA geometry (source at z = 4000, near/far
    4000 -+ 100, a carved grid, the interim k = 192 and the settled
    two-bucket Tuning of the LCA runs) against the JAX render's
    value_and_grad with copied weights: loss within rel 1e-4, pixels within
    1e-4, every parameter's gradient within 3e-2 of its largest entry and
    at cosine >= 0.9999."""
    import importlib

    from nerf_for_angiography_tpu.ops import occupancy as oj
    from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ
    from nerf_for_angiography_tpu.training import create_train_state as create_train_state_j
    from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
    from nerf_for_angiography_tpu_torch.ops import occupancy as ot
    from nerf_for_angiography_tpu_torch.ops.sampling import RayBatch
    from nerf_for_angiography_tpu_torch.training import create_train_state

    tj = importlib.import_module("nerf_for_angiography_tpu.training.train")
    tt = importlib.import_module("nerf_for_angiography_tpu_torch.training.train")
    ds = generate_dataset_j(make_lca_sdf_volume_j(res=48),
                            sdf_datagen_config_j(img_width=40, img_height=36,
                                                 sample_outside=100.0))
    rays = jax.tree.map(np.asarray, ds.rays._replace(sampling_table=None))
    idx = np.random.default_rng(0).choice(rays.origins.shape[0], 128, replace=False)
    o, d, tgt = rays.origins[idx], rays.directions[idx], rays.pixel_values[idx]
    near, far = 3900.0, 4100.0
    aabb = np.array([-100.0] * 3 + [100.0] * 3, np.float32)
    feas = np.asarray(oj.carve_feasible(jnp.asarray(rays.origins), jnp.asarray(rays.directions),
                                        jnp.asarray(rays.pixel_values), jnp.asarray(aabb), 64,
                                        near, far))
    grid_j = oj.with_packed(oj.OccupancyGrid(occs=jnp.zeros((64,) * 3), binary=jnp.asarray(feas),
                                             aabb=jnp.asarray(aabb)))
    grid_t = ot.grid_from_numpy(feas, aabb)
    kw = dict(sample_size=8, depth_samples_per_ray=300, grid_resolution=64, num_layers=2,
              num_hidden_units=32, sampling_strategy="random", coarse_lr=1e-3,
              compact_samples={"lattice": 192, "hybrid2k": 192, "dense": 0}[march],
              march_mode="hybrid" if march == "hybrid2k" else "lattice", hybrid_w_cap=224,
              hybrid_w_lo=160, hybrid_split=0.75, hybrid_bucket_k=True, hybrid_k_lo=80)
    cfg_j = TrainConfigJ(**kw, mlp_backend="xla", compute_dtype="bfloat16")
    model_j, state_j = create_train_state_j(cfg_j, jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, state_j.params)

    def loss_fn(params):
        pix, _, _ = tj.render_rays(model_j, params, grid_j, jnp.asarray(o), jnp.asarray(d),
                                   cfg_j, near, far)
        return jnp.mean((pix - jnp.asarray(tgt)) ** 2), pix

    (loss_j, pix_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params0))
    cfg_t = TrainConfig(**kw)
    model_t, state_t = create_train_state(cfg_t, device="cpu")
    model_t.load_state_dict(cppn_params_from_jax(params0))
    state_t.grid, state_t.vessel_grid, state_t.step = grid_t, grid_t, 1  # no grid update
    batch = RayBatch(_t(o), _t(d), _t(tgt), torch.zeros(128, dtype=torch.int64))
    state_t, metrics_t, pix_t, _ = tt.make_train_step(model_t, cfg_t, near, far).step_core(
        state_t, batch)
    assert float(metrics_t["loss/train-pixel-coarse"]) == pytest.approx(float(loss_j), rel=1e-4)
    np.testing.assert_allclose(pix_t.numpy(), np.asarray(pix_j), rtol=0, atol=1e-4)
    grads_t = {n: p.grad for n, p in model_t.named_parameters()}
    for name, g_j in cppn_params_from_jax(jax.tree.map(np.asarray, grads_j)).items():
        if name in ("img1", "img2"):
            continue
        want, got = g_j.numpy().ravel(), grads_t[name].numpy().ravel()
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(got / scale, want / scale, atol=3e-2, err_msg=name)
        cos = float(got @ want / np.sqrt((got @ got) * (want @ want)))
        assert cos >= 0.9999, (name, cos)
