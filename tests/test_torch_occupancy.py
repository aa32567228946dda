"""Port: occupancy grid, dense march, carving and prune mask against the JAX
package on the same inputs (numpy from a seed). Integer-valued outputs
(masks, binaries) must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.ops import occupancy as oj
from nerf_for_angiography_tpu_torch.ops import occupancy as ot

AABB = [-100.0] * 3 + [100.0] * 3
NEAR, FAR = 1400.0, 1600.0


def _rays(n=200, seed=0):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-20, 20, (n, 2))
    o[:, 2] = 1500.0
    target = rng.uniform(-120, 120, (n, 3)).astype(np.float32)
    target[:, 2] = 0.0
    d = ((target - o) / 1500.0).astype(np.float32)
    return o, d


def _grids(res, seed=1):
    binary = np.random.default_rng(seed).random((res, res, res)) < 0.3
    gj = oj.with_packed(oj.create_grid(jnp.asarray(AABB), res)._replace(binary=jnp.asarray(binary)))
    gt = ot.create_grid(AABB, res, device="cpu")._replace(binary=torch.from_numpy(binary))
    return gj, gt


@pytest.mark.parametrize("occ_stride", [1, 2])
@pytest.mark.parametrize("res,n_samples", [(16, 32), (8, 48)])
def test_march_rays_mask_exact(occ_stride, res, n_samples):
    o, d = _rays()
    gj, gt = _grids(res)
    mj = oj.march_rays(gj, jnp.asarray(o), jnp.asarray(d), n_samples, NEAR, FAR,
                       occ_stride=occ_stride)
    mt = ot.march_rays(gt, torch.from_numpy(o), torch.from_numpy(d), n_samples, NEAR, FAR,
                       occ_stride=occ_stride)
    np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
    assert 0 < mt.mask.sum() < mt.mask.numel()
    np.testing.assert_allclose(mt.t_starts.numpy(), np.asarray(mj.t_starts), rtol=1e-6)
    np.testing.assert_allclose(mt.positions.numpy(), np.asarray(mj.positions), rtol=1e-6, atol=1e-4)


def test_ray_aabb_intersect_ordering():
    o, d = _rays(300, seed=4)
    ej, xj = oj.ray_aabb_intersect(jnp.asarray(AABB), jnp.asarray(o), jnp.asarray(d))
    et, xt = ot.ray_aabb_intersect(torch.tensor(AABB), torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal((et > xt).numpy(), np.asarray(ej > xj))
    assert (et > xt).any() and (et <= xt).any()
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-6)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6)


def _sigma_j(shift):
    def fn(pts):
        r2 = jnp.sum((pts - jnp.array([shift, 0.0, 0.0])) ** 2, axis=-1)
        return 1.0 / (1.0 + jnp.exp(-(4.0 - r2 / 500.0)))
    return fn


def _sigma_t(shift):
    def fn(pts):
        r2 = torch.sum((pts - torch.tensor([shift, 0.0, 0.0])) ** 2, dim=-1)
        return 1.0 / (1.0 + torch.exp(-(4.0 - r2 / 500.0)))
    return fn


def _assert_grid_equal(gt, gj):
    np.testing.assert_array_equal(gt.binary.numpy(), np.asarray(gj.binary))
    np.testing.assert_allclose(gt.occs.numpy(), np.asarray(gj.occs), rtol=1e-5, atol=1e-7)


def test_update_grid_pair_exact():
    res = 16
    gj, vj = oj.create_grid(jnp.asarray(AABB), res), oj.create_grid(jnp.asarray(AABB), res)
    gt, vt = ot.create_grid(AABB, res), ot.create_grid(AABB, res)
    for it in range(3):
        gj, vj = oj.update_grid_pair(gj, vj, _sigma_j(10.0 * it), 1e-4, 5e-2, 0.9)
        gt, vt = ot.update_grid_pair(gt, vt, _sigma_t(10.0 * it), 1e-4, 5e-2, 0.9)
        _assert_grid_equal(gt, gj)
        _assert_grid_equal(vt, vj)
    assert 0 < int(vt.binary.sum()) < res**3


def test_update_grid_pair_slab_exact():
    res = 16
    gj, vj = oj.create_grid(jnp.asarray(AABB), res), oj.create_grid(jnp.asarray(AABB), res)
    gt, vt = ot.create_grid(AABB, res), ot.create_grid(AABB, res)
    for idx in range(5):
        gj, vj = oj.update_grid_pair_slab(gj, vj, _sigma_j(5.0 * idx), 1e-4, 5e-2,
                                          update_idx=jnp.asarray(idx), n_slabs=4)
        gt, vt = ot.update_grid_pair_slab(gt, vt, _sigma_t(5.0 * idx), 1e-4, 5e-2,
                                          update_idx=idx, n_slabs=4)
        _assert_grid_equal(gt, gj)
        _assert_grid_equal(vt, vj)


def test_every_n_step_pair_exact():
    """Host-side step gate: dense updates in warmup, slabs after, skips
    between, identical to the lax.cond version."""
    res = 16
    gj, vj = oj.create_grid(jnp.asarray(AABB), res), oj.create_grid(jnp.asarray(AABB), res)
    gt, vt = ot.create_grid(AABB, res), ot.create_grid(AABB, res)
    for step in range(10):
        kw = dict(n=2, ema_decay=0.9, slabs=4, warmup_steps=4)
        gj, vj = oj.every_n_step_pair(gj, vj, jnp.asarray(step), _sigma_j(3.0 * step),
                                      1e-4, 5e-2, **kw)
        gt, vt = ot.every_n_step_pair(gt, vt, step, _sigma_t(3.0 * step), 1e-4, 5e-2, **kw)
        _assert_grid_equal(gt, gj)
        _assert_grid_equal(vt, vj)


def test_carve_feasible_exact():
    o, d = _rays(500, seed=7)
    pix = np.where(np.random.default_rng(2).random(500) < 0.6, 1.0, 0.5).astype(np.float32)
    fj = oj.carve_feasible(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pix), AABB, 16,
                           NEAR, FAR, chunk=128)
    ft = ot.carve_feasible(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(pix),
                           AABB, 16, NEAR, FAR, chunk=128)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert 0 < int(ft.sum()) < 16**3


def test_cell_centers_and_dilate():
    gj = oj.create_grid(jnp.asarray(AABB), 8)
    gt = ot.create_grid(AABB, 8)
    np.testing.assert_allclose(ot.cell_centers(gt).numpy(), np.asarray(oj.cell_centers(gj)),
                               rtol=1e-6)
    x = np.random.default_rng(3).random((8, 8, 8)) < 0.05
    np.testing.assert_array_equal(ot._dilate3(torch.from_numpy(x)).numpy(),
                                  np.asarray(oj._dilate3(jnp.asarray(x))))


@pytest.mark.parametrize("alpha_thre,eps", [(0.0, 1e-2), (1e-2, 1e-2), (0.0, 0.0)])
def test_prune_mask_close(alpha_thre, eps):
    rng = np.random.default_rng(5)
    sigma = rng.random((64, 40)).astype(np.float32)
    dists = np.full((64, 40), 0.2, np.float32)
    mask = (rng.random((64, 40)) < 0.7).astype(np.float32)
    kj = oj.prune_mask(jnp.asarray(sigma), jnp.asarray(dists), jnp.asarray(mask), alpha_thre, eps)
    kt = ot.prune_mask(torch.from_numpy(sigma), torch.from_numpy(dists), torch.from_numpy(mask),
                       alpha_thre, eps)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-6)


def test_safe_occ_stride_and_compacted_march_raise():
    """safe_occ_stride's fallback, and compact_k (which raised before the
    compacted marches were ported) now returns k-wide outputs."""
    with pytest.warns(UserWarning):
        assert ot.safe_occ_stride(2, 32, NEAR, FAR, 200.0, 16) == 1
    assert ot.safe_occ_stride(2, 300, NEAR, FAR, 200.0, 128) == 2
    gj, gt = _grids(8)
    o, d = _rays(4)
    m = ot.march_rays(gt, torch.from_numpy(o), torch.from_numpy(d), 32, NEAR, FAR, compact_k=8)
    assert m.mask.shape == m.t_starts.shape == (4, 8) and m.positions.shape == (4, 8, 3)
    assert m.active_count.shape == m.edge_active.shape == (4,)
