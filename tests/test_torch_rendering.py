"""Port: ops/rendering.py, the depth helpers of geometry/rays.py and the
image samplers of ops/sampling.py against the JAX package, on the same
seeded inputs (f32, rtol 1e-5; the random draws are JAX's, injected)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.geometry import rays as rays_j
from nerf_for_angiography_tpu.ops import rendering as rj
from nerf_for_angiography_tpu.ops import sampling as sj
from nerf_for_angiography_tpu_torch.geometry import get_depth_values, segment_lengths
from nerf_for_angiography_tpu_torch.ops import rendering as rt
from nerf_for_angiography_tpu_torch.ops import sampling as st

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(0)
    n_rays, n = 40, 24
    depths = np.sort(rng.uniform(1400, 1600, (n_rays, n)), axis=-1).astype(np.float32)
    sigma = rng.uniform(0, 0.05, (n_rays, n)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    mask = (rng.uniform(size=(n_rays, n)) > 0.3).astype(np.float32)
    raw2 = rng.normal(size=(n_rays, n, 2)).astype(np.float32)
    return dict(depths=depths, sigma=sigma, dirs=dirs, mask=mask, raw2=raw2)


def test_cumprod_sigma_activation_and_dists(field):
    x = np.random.default_rng(1).uniform(0.5, 1.0, (7, 9)).astype(np.float32)
    _close(rt.cumprod_exclusive(_t(x)), rj.cumprod_exclusive(jnp.asarray(x)))
    for raw in (field["raw2"], field["raw2"][..., :1]):
        _close(rt.sigma_activation(_t(raw)), rj.sigma_activation(jnp.asarray(raw)))
    d = field["depths"]
    _close(rt.segment_dists(_t(d)), rj.segment_dists(jnp.asarray(d)))
    _close(rt.segment_dists(_t(d), _t(field["dirs"])),
           rj.segment_dists(jnp.asarray(d), jnp.asarray(field["dirs"])))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_dists", [False, True])
def test_render_xray_and_its_gradient(field, masked, with_dists):
    d, s = field["depths"], field["sigma"]
    dirs = field["dirs"]
    mask = field["mask"] if masked else None
    dists = np.diff(d, axis=-1, append=d[:, -1:] + 0.5).astype(np.float32) if with_dists else None
    tgt = np.random.default_rng(2).uniform(0.2, 1.0, d.shape[0]).astype(np.float32)

    def loss_j(sig):
        r = rj.render_xray(sig, jnp.asarray(d), jnp.asarray(dirs),
                           None if mask is None else jnp.asarray(mask),
                           None if dists is None else jnp.asarray(dists))
        return (jnp.mean((r.pixels - tgt) ** 2) + jnp.mean(r.depth) * 1e-6
                + jnp.mean(r.weights) + jnp.mean(r.entropy)), r

    (lj, r_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(jnp.asarray(s))
    sig_t = _t(s).requires_grad_(True)
    r_t = rt.render_xray(sig_t, _t(d), _t(dirs), None if mask is None else _t(mask),
                         None if dists is None else _t(dists))
    lt = (torch.mean((r_t.pixels - _t(tgt)) ** 2) + r_t.depth.mean() * 1e-6
          + r_t.weights.mean() + r_t.entropy.mean())
    lt.backward()
    for a, b in zip(r_t, r_j):
        _close(a.detach(), b, rtol=RTOL, atol=1e-5)
    _close(lt.detach(), lj)
    _close(sig_t.grad, g_j, rtol=1e-4, atol=1e-6)


def test_ray_entropy_and_rgb_sigma(field):
    s, px = field["sigma"], np.linspace(0, 1, field["sigma"].shape[0], dtype=np.float32)
    _close(rt.ray_entropy(_t(s), _t(px)), rj.ray_entropy(jnp.asarray(s), jnp.asarray(px)))
    raw = field["raw2"] * np.float32(0.01)
    want = rj.render_rgb_sigma(jnp.asarray(raw), jnp.asarray(field["depths"]))
    got = rt.render_rgb_sigma(_t(raw), _t(field["depths"]))
    for a, b in zip(got, want):
        _close(a, b, atol=1e-5)


def test_sample_pdf_and_fine_sampling_on_jax_uniforms(field):
    d = field["depths"]
    rng = np.random.default_rng(3)
    w = rng.uniform(0, 1, d.shape).astype(np.float32)
    mids = 0.5 * (d[:, 1:] + d[:, :-1])
    key = jax.random.PRNGKey(11)
    n = 16
    want = rj.sample_pdf(jnp.asarray(mids), jnp.asarray(w[:, 1:-1]), n, key)
    u = jax.random.uniform(key, (d.shape[0], n), dtype=jnp.float32)
    got = rt.sample_pdf_at(_t(mids), _t(w[:, 1:-1]), _t(u))
    _close(got, want, rtol=RTOL, atol=1e-3)  # depths ~1500: 1e-3 is under 1 f32 ulp
    want_f = rj.fine_sampling(jnp.asarray(d), jnp.asarray(w), n, key)
    got_f = rt.fine_sampling_at(_t(d), _t(w), _t(u))
    assert got_f.shape == want_f.shape == (d.shape[0], d.shape[1] + n)
    _close(got_f, want_f, rtol=RTOL, atol=1e-3)
    # a 1-D depth vector broadcasts over the weights' rays
    want_1 = rj.fine_sampling(jnp.asarray(d[0]), jnp.asarray(w), n, key)
    _close(rt.fine_sampling_at(_t(d[0]), _t(w), _t(u)), want_1, rtol=RTOL, atol=1e-3)
    g = torch.Generator().manual_seed(0)
    draw = rt.fine_sampling(_t(d), _t(w), n, g)
    assert draw.shape == got_f.shape and bool((draw.diff(dim=-1) >= 0).all())


def test_ndc_rays_and_psnr():
    rng = np.random.default_rng(4)
    o = rng.normal(size=(20, 3)).astype(np.float32) + np.array([0, 0, 1500], np.float32)
    dvec = rng.normal(size=(20, 3)).astype(np.float32) - np.array([0, 0, 2], np.float32)
    want = rj.ndc_rays(75.0, 1300.0, 1400.0, jnp.asarray(o), jnp.asarray(dvec))
    got = rt.ndc_rays(75.0, 1300.0, 1400.0, _t(o), _t(dvec))
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-4, atol=1e-6)
    mse = np.array([1e-3, 0.25, 2.0], np.float32)
    _close(rt.psnr_from_mse(_t(mse)), rj.psnr_from_mse(jnp.asarray(mse)))


def test_depth_values_and_segment_lengths():
    want = rays_j.get_depth_values(1400.0, 1600.0, 33, stratified=False)
    _close(get_depth_values(1400.0, 1600.0, 33, stratified=False), want)
    with pytest.raises(ValueError):
        get_depth_values(1400.0, 1600.0, 33)
    z = get_depth_values(1400.0, 1600.0, 33, torch.Generator().manual_seed(0))
    assert bool((z >= 1400.0).all()) and bool((z <= 1600.0).all())
    d = np.sort(np.random.default_rng(5).uniform(0, 10, (4, 9)), -1).astype(np.float32)
    for inf in (True, False):
        _close(segment_lengths(_t(d), inf), rays_j.segment_lengths(jnp.asarray(d), inf))


def _rays(n_views=5, per=36):
    rng = np.random.default_rng(6)
    n = n_views * per
    return (rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(size=n).astype(np.float32), rng.uniform(size=n).astype(np.float32),
            np.repeat(np.arange(n_views), per).astype(np.int32),
            np.tile(np.arange(per), n_views).astype(np.int32),
            np.zeros(n, np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_image_rays_on_jax_draws(seed):
    arrays = _rays()
    data_j = sj.RayDataset(*(jnp.asarray(a) for a in arrays))
    data_t = st.RayDataset(*(torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
                             for a in arrays))
    key = jax.random.PRNGKey(seed)
    want = sj.sample_image_rays(key, data_j, 12, 4, 36)
    k_img, k_pix = jax.random.split(key)
    img = int(jax.random.randint(k_img, (), 0, 4))
    offs = np.asarray(jax.random.choice(k_pix, 36, (12,), replace=False))
    got = st.image_ray_select(data_t, torch.tensor(img), torch.from_numpy(offs.astype(np.int64)),
                              36)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port's own draws: one view, distinct pixels
    b = st.sample_image_rays(torch.Generator().manual_seed(seed), data_t, 12, 4, 36)
    assert len(set(b.image_ids.tolist())) == 1 and int(b.image_ids[0]) < 4
    assert len(set(map(tuple, b.origins.tolist()))) == 12
    whole_j = sj.whole_image_rays(data_j, 3, 36)
    for a, c in zip(st.whole_image_rays(data_t, 3, 36), whole_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
