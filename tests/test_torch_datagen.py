"""Port: geometry, DRR rendering, Frangi weights and the datagen sweep
against the JAX package on the same volume and angles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.data import DatagenConfig as DatagenConfigJ
from nerf_for_angiography_tpu.data import generate_dataset as generate_dataset_j
from nerf_for_angiography_tpu.data import make_vessel_volume as make_vessel_volume_j
from nerf_for_angiography_tpu.data.drr import render_drr as render_drr_j
from nerf_for_angiography_tpu.data.drr import render_view as render_view_j
from nerf_for_angiography_tpu.data.weights import get_weighted_img as weighted_j
from nerf_for_angiography_tpu.geometry import get_ray_values as get_ray_values_j
from nerf_for_angiography_tpu.geometry import linspace_depths as linspace_j
from nerf_for_angiography_tpu_torch.data import (
    DatagenConfig,
    angle_grid,
    generate_dataset,
    get_weighted_img,
    make_sphere_volume,
    make_vessel_volume,
    render_drr,
    render_view,
)
from nerf_for_angiography_tpu_torch.geometry import get_ray_values, linspace_depths

SRC = np.array([0.0, 0.0, 1500.0], np.float32)


@pytest.mark.parametrize("theta,phi,larm", [(90.0, 0.0, 0.0), (135.0, 135.0, 0.0), (45.0, 30.0, 10.0)])
def test_get_ray_values_close(theta, phi, larm):
    oj, dj, cj = get_ray_values_j(theta, phi, larm, SRC, 16, 12, 1300.0)
    ot, dt, ct = get_ray_values(theta, phi, larm, SRC, 16, 12, 1300.0)
    assert ot.shape == (12, 16, 3)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-6)


def test_render_drr_close():
    vol_j = make_vessel_volume_j(res=32)
    vol_t = make_vessel_volume(res=32)
    np.testing.assert_array_equal(vol_t.values.numpy(), np.asarray(vol_j.values))
    oj, dj, _ = get_ray_values_j(90.0, 0.0, 0.0, SRC, 16, 16, 1300.0)
    ot, dt, _ = get_ray_values(90.0, 0.0, 0.0, SRC, 16, 16, 1300.0)
    zj = linspace_j(1400.0, 1600.0, 200)
    zt = linspace_depths(1400.0, 1600.0, 200)
    want = np.asarray(render_drr_j(vol_j, oj, dj, zj))
    got = render_drr(vol_t, ot, dt, zt).numpy()
    assert got.min() < 0.99  # the vessels attenuate
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_render_view_close():
    vol_j = make_vessel_volume_j(res=32)
    vol_t = make_vessel_volume(res=32)
    zj = linspace_j(1400.0, 1600.0, 100)
    zt = linspace_depths(1400.0, 1600.0, 100)
    args = (120.0, 20.0, 5.0, SRC, 16, 12, 1300.0)
    want = render_view_j(vol_j, *args, zj, translation=(2.0, -1.0, 0.5))
    got = render_view(vol_t, *args, zt, translation=(2.0, -1.0, 0.5))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("strategy", ["frangi", "segmentation"])
def test_weight_maps_equal(strategy):
    img = np.ones((24, 24), np.float32)
    img[10:14, :] = 0.4
    img[:, 5:7] = 0.6
    np.testing.assert_array_equal(
        get_weighted_img(img, 0.5, 0.5, strategy), weighted_j(img, 0.5, 0.5, strategy)
    )


def test_generate_dataset_close():
    kw = dict(limited_size=90.0, number_angles=1.0, img_width=16, img_height=16,
              sample_outside=100.0, stratified_depths=False)
    ds_j = generate_dataset_j(make_vessel_volume_j(res=32), DatagenConfigJ(**kw))
    ds_t = generate_dataset(make_vessel_volume(res=32), DatagenConfig(**kw), device="cpu")
    np.testing.assert_array_equal(ds_t.angles, ds_j.angles)
    assert ds_t.rays.num_rays == 5 * 16 * 16
    r_j, r_t = ds_j.rays, ds_t.rays
    np.testing.assert_allclose(r_t.origins.numpy(), np.asarray(r_j.origins), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(r_t.directions.numpy(), np.asarray(r_j.directions), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ds_t.images, ds_j.images, atol=1e-5)
    np.testing.assert_allclose(r_t.pixel_values.numpy(), np.asarray(r_j.pixel_values), atol=1e-5)
    np.testing.assert_allclose(ds_t.weight_maps, ds_j.weight_maps, atol=1e-4)
    for name in ("image_ids", "x_positions", "y_positions"):
        np.testing.assert_array_equal(getattr(r_t, name).numpy(), np.asarray(getattr(r_j, name)))


def test_angle_grid_and_sphere():
    np.testing.assert_array_equal(angle_grid(180.0, 4.0)[-1], [135.0, 135.0])
    assert angle_grid(180.0, 4.0).shape == (26, 2)
    vol = make_sphere_volume(res=16)
    assert float(vol.values.max()) == pytest.approx(0.02)


# the SDF options (angle_mode 'sdf', per_image_normalize) are ported; the
# pose shifts stay refused, and a non-identity resize_to is a ValueError
# (test_resize_to_must_be_identity)
@pytest.mark.parametrize("kw", [dict(max_shift_rotation=1.0), dict(max_shift_translation=0.1),
                                dict(max_shift_rotation=1.0, max_shift_translation=0.1)])
def test_unported_datagen_raises(kw):
    with pytest.raises(NotImplementedError):
        generate_dataset(make_sphere_volume(res=8), DatagenConfig(**kw), device="cpu")


def test_resize_to_must_be_identity():
    cfg = DatagenConfig(number_angles=1.0, img_width=8, img_height=8, resize_to=(4, 8))
    with pytest.raises(ValueError, match="resize_to"):
        generate_dataset(make_sphere_volume(res=8), cfg, device="cpu")


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_dataset(make_sphere_volume(res=8), DatagenConfig(number_angles=1.0))
