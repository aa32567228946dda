"""Port: pose refinement and image sampling against the JAX package. The
pose-shift datagen on JAX's injected shifts (images, rays, the proj
columns; a pose dataset's proj CSV through both writers byte for byte), one
pose step (dense, lattice, hybrid2k) against the JAX loss's value_and_grad
with non-zero view shifts copied across, the AdamW update of the shifts
against optax, the pose_start curriculum, tiny pose and sample_mode='image'
train() runs, the slow recovery test, and bundles, checkpoints and
Reconstruction of the new branches. The card's tests of pose steps (dx at
a trained pose step's own g, replayed against eager pose steps) are in
tests/test_torch_cuda.py, which imports torch only."""

import dataclasses
import filecmp
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_for_angiography_tpu.data import DatagenConfig as DatagenConfigJ
from nerf_for_angiography_tpu.data import generate_dataset as generate_dataset_j
from nerf_for_angiography_tpu.data import make_sphere_volume as make_sphere_volume_j
from nerf_for_angiography_tpu.data import make_vessel_volume as make_vessel_volume_j
from nerf_for_angiography_tpu.data import write_proj_csv as write_proj_csv_j
from nerf_for_angiography_tpu.ops import occupancy as oj
from nerf_for_angiography_tpu.ops.sampling import RayBatch as RayBatchJ
from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ
from nerf_for_angiography_tpu.training import create_train_state as create_train_state_j
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
from nerf_for_angiography_tpu_torch.data import datasets as dst
from nerf_for_angiography_tpu_torch.data import (
    DatagenConfig,
    GeneratedDataset,
    generate_dataset,
    make_sphere_volume,
    make_vessel_volume,
    write_proj_csv,
)
from nerf_for_angiography_tpu_torch.ops import occupancy as ot
from nerf_for_angiography_tpu_torch.ops.sampling import RayBatch, RayDataset
from nerf_for_angiography_tpu_torch.training import (
    TrainConfig,
    create_train_state,
    make_train_step,
    train,
)

# the modules (each package's ``train`` attribute is the function)
tj = importlib.import_module("nerf_for_angiography_tpu.training.train")
tt = importlib.import_module("nerf_for_angiography_tpu_torch.training.train")

NEAR, FAR = 1400.0, 1600.0
N = 64  # samples per ray in the step tests
AABB = np.array([-100.0] * 3 + [100.0] * 3, np.float32)
SHIFT_COLUMNS = ("theta_shift", "phi_shift", "larm_shift", "translation_x", "translation_y",
                 "translation_z")
DATAGEN = dict(limited_size=90.0, number_angles=1.0, img_width=12, img_height=10,
               sample_outside=100.0, stratified_depths=False)


def _jax_pose_dataset(**kw):
    return generate_dataset_j(make_vessel_volume_j(res=24), DatagenConfigJ(**{**DATAGEN, **kw}),
                              key=jax.random.PRNGKey(5))


def _injected(ds_j):
    """JAX's drawn shifts (the proj columns, f32 draws stored as floats) in
    place of the port's draw."""
    cols = [np.asarray(ds_j.proj[c], np.float32) for c in SHIFT_COLUMNS]
    rot, tr = np.stack(cols[:3], -1), np.stack(cols[3:], -1)
    return lambda config, n_views, generator, grid_dim: (rot, tr)


@pytest.mark.parametrize("kw", [
    dict(max_shift_translation=0.05, rays_from_nominal=True),
    dict(max_shift_rotation=2.0, max_shift_translation=0.05, rays_from_nominal=True),
    dict(max_shift_rotation=3.0),
])
def test_pose_shift_datagen_matches_jax(kw, monkeypatch):
    """The pose-shift sweep on JAX's injected shifts: the images, rays and
    every proj column of the JAX dataset (matrices within f32 rounding,
    the shift columns exactly; the test view unshifted)."""
    ds_j = _jax_pose_dataset(**kw)
    monkeypatch.setattr(dst, "pose_shifts", _injected(ds_j))
    ds_t = generate_dataset(make_vessel_volume(res=24), DatagenConfig(**{**DATAGEN, **kw}),
                            device="cpu")
    for c in SHIFT_COLUMNS:
        assert list(ds_t.proj[c]) == list(ds_j.proj[c]), c
        assert ds_t.proj[c][-1] == 0.0
    assert np.abs(np.asarray(ds_j.proj["translation_x"][:-1])).max() > 0 or "rotation" in str(kw)
    assert list(ds_t.proj) == list(ds_j.proj.columns)
    for c in ("tform_cam2world", "unshifted_tform_cam2world"):
        np.testing.assert_allclose(np.stack(ds_t.proj[c]), np.array(list(ds_j.proj[c])),
                                   rtol=1e-5, atol=1e-3)
    r_t, r_j = ds_t.rays, ds_j.rays
    np.testing.assert_allclose(r_t.origins.numpy(), np.asarray(r_j.origins), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(r_t.directions.numpy(), np.asarray(r_j.directions), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ds_t.images, ds_j.images, atol=1e-5)
    np.testing.assert_allclose(ds_t.weight_maps, ds_j.weight_maps, atol=1e-4)
    if kw.get("rays_from_nominal"):
        # nominal rays: the origins are the unshifted cameras'
        c2w = np.array(list(ds_j.proj["unshifted_tform_cam2world"]), np.float32)
        per = DATAGEN["img_width"] * DATAGEN["img_height"]
        np.testing.assert_allclose(r_t.origins.numpy()[::per], c2w[:, :3, 3], atol=1e-3)


def test_pose_dataset_proj_csv_is_the_jax_bytes(tmp_path):
    """A pose dataset's proj table (the shift columns and the unshifted
    matrices among them) through both packages' writers: the same bytes."""
    ds_j = _jax_pose_dataset(max_shift_rotation=2.0, max_shift_translation=0.05,
                             rays_from_nominal=True)
    proj = {c: ds_j.proj[c].tolist() for c in ds_j.proj.columns}
    rays = RayDataset(*(torch.from_numpy(np.array(a)) for a in ds_j.rays[:7]))
    ds = GeneratedDataset(proj=proj, rays=rays, images=ds_j.images,
                          weight_maps=ds_j.weight_maps, angles=ds_j.angles)
    write_proj_csv_j(ds_j, str(tmp_path / "jax.csv"))
    write_proj_csv(ds, str(tmp_path / "port.csv"))
    assert filecmp.cmp(tmp_path / "jax.csv", tmp_path / "port.csv", shallow=False)


def test_port_draws_the_shifts_in_range():
    cfg = DatagenConfig(**{**DATAGEN, "max_shift_rotation": 2.0, "max_shift_translation": 0.05})
    vol = make_sphere_volume(res=16)
    dim = dst.max_grid_dim(vol)
    rot, tr = dst.pose_shifts(cfg, 5, torch.Generator().manual_seed(0), dim)
    assert rot.dtype == tr.dtype == np.float32 and rot.shape == tr.shape == (5, 3)
    assert (rot[-1] == 0).all() and (tr[-1] == 0).all()
    assert np.abs(rot).max() <= 2.0 and np.abs(tr).max() <= 0.05 * dim and np.abs(tr).max() > 0
    bounds = np.abs(np.concatenate([np.asarray(make_sphere_volume_j(res=16).origin),
                                    np.asarray(make_sphere_volume_j(res=16).origin)
                                    + np.asarray(make_sphere_volume_j(res=16).spacing) * 15]))
    assert dim == float(bounds.max())


# ---------------------------------------------------------------------------
# one pose step against the JAX loss
# ---------------------------------------------------------------------------

def _blob_binary(res, seed=1):
    rng = np.random.default_rng(seed)
    idx = np.stack(np.meshgrid(*[np.arange(res) + 0.5] * 3, indexing="ij"), -1)
    binary = np.zeros((res,) * 3, bool)
    for _ in range(6):
        c = rng.uniform(0.2, 0.8, 3) * res
        r = rng.uniform(0.06, 0.14) * res
        binary |= ((idx - c) ** 2).sum(-1) < r * r
    return binary


def _batch(n_rays=64, n_views=4, seed=0):
    rng = np.random.default_rng(seed)
    o = np.zeros((n_rays, 3), np.float32)
    o[:, :2] = rng.uniform(-20, 20, (n_rays, 2))
    o[:, 2] = 1500.0
    target = rng.uniform(-110, 110, (n_rays, 3)).astype(np.float32)
    target[:, 2] = 0.0
    d = ((target - o) / 1500.0).astype(np.float32)
    px = rng.uniform(0.3, 1.0, n_rays).astype(np.float32)
    ids = rng.integers(0, n_views - 1, n_rays).astype(np.int32)
    return o, d, px, ids


POSE_MARCHES = {
    "dense": dict(compact_samples=0),
    "lattice": dict(compact_samples=24, march_mode="lattice"),
    "hybrid2k": dict(compact_samples=24, march_mode="hybrid", hybrid_w_cap=48, hybrid_w_lo=24,
                     hybrid_split=0.75, hybrid_bucket_k=True, hybrid_k_lo=12),
}


@pytest.mark.parametrize("march", list(POSE_MARCHES))
def test_pose_step_matches_jax(march):
    """One pose step of the port's step_core against the JAX step's loss
    (origins + view_shifts[image_ids], then render_rays) and its
    value_and_grad, with non-zero view shifts and the weights copied across
    and the same grid: loss rel 2e-2, pixels, every normalised gradient
    (view_shifts among them, non-zero) at atol 3e-2, the march's pressure;
    then the new weights and shifts against the unjitted JAX step's."""
    n_views = 4
    kw = dict(sample_size=8, depth_samples_per_ray=N, grid_resolution=16, num_layers=2,
              num_hidden_units=32, sampling_strategy="random", coarse_lr=1e-3,
              pose_refine=True, pose_lr=3e-2, pose_start=0, **POSE_MARCHES[march])
    cfg_j = TrainConfigJ(**kw, mlp_backend="xla", compute_dtype="bfloat16")
    cfg_t = TrainConfig(**kw)
    b = _blob_binary(16)
    gj = oj.with_packed(oj.OccupancyGrid(occs=jnp.zeros((16,) * 3, jnp.float32),
                                         binary=jnp.asarray(b), aabb=jnp.asarray(AABB)))
    gt = ot.grid_from_numpy(b, AABB)
    o, d, px, ids = _batch(n_views=n_views)

    model_j, state_j = create_train_state_j(cfg_j, jax.random.PRNGKey(0), num_views=n_views)
    shifts = np.random.default_rng(7).uniform(-2, 2, (n_views, 3)).astype(np.float32)
    params0 = jax.tree.map(np.asarray, state_j.params)
    params0["params"]["view_shifts"] = shifts

    def loss_fn(params):
        origins = jnp.asarray(o) + params["params"]["view_shifts"][jnp.asarray(ids)]
        pix, _, _, m = tj.render_rays(model_j, params, gj, origins, jnp.asarray(d), cfg_j,
                                      NEAR, FAR, return_march=True)
        pres = tj.march_pressure(m) if march != "dense" else {}
        return jnp.mean((pix - jnp.asarray(px)) ** 2), (pix, pres)

    (loss_j, (pix_j, pres_j)), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params0))

    model_t, state_t = create_train_state(cfg_t, num_views=n_views, device="cpu")
    model_t.load_state_dict(cppn_params_from_jax(params0))
    state_t.grid, state_t.vessel_grid, state_t.step = gt, gt, 1  # no grid update at step 1
    step_t = make_train_step(model_t, cfg_t, NEAR, FAR)
    batch = RayBatch(*(torch.from_numpy(a) for a in (o, d, px, ids.astype(np.int64))))
    if march == "hybrid2k":
        assert isinstance(tt._march_for(cfg_t, gt, batch.origins, batch.directions, NEAR, FAR),
                          ot.BucketedRays)
    state_t, metrics_t, pix_t, _ = step_t.step_core(state_t, batch)

    assert float(metrics_t["loss/train-pixel-coarse"]) == pytest.approx(float(loss_j), rel=2e-2)
    np.testing.assert_allclose(pix_t.numpy(), np.asarray(pix_j), atol=2e-2)
    for k, v in pres_j.items():
        assert int(metrics_t[k]) == int(v), k
    grads_t = {n: p.grad for n, p in model_t.named_parameters()}
    g_shift = grads_t["view_shifts"].numpy()
    assert np.abs(g_shift[:-1]).max() > 0 and (g_shift[-1] == 0).all()
    for name, g in cppn_params_from_jax(jax.tree.map(np.asarray, grads_j)).items():
        if name in ("img1", "img2"):
            continue
        want = g.numpy()
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(grads_t[name].numpy() / scale, want / scale, atol=3e-2,
                                   err_msg=name)

    # the update: the unjitted JAX step on the same batch (its grid update
    # skipped at step 1) against the port's new parameters
    state_j = state_j._replace(params=jax.tree.map(jnp.asarray, params0), grid=gj,
                               vessel_grid=gj, step=jnp.asarray(1, jnp.int32))
    batch_j = RayBatchJ(*(jnp.asarray(x) for x in (o, d, px, ids)))
    mp = pytest.MonkeyPatch()
    mp.setattr(tj, "sample_pixel_rays", lambda *a, **k: batch_j)
    try:
        state_j1, _, _, _ = tj._build_train_step(model_j, cfg_j, NEAR, FAR)(state_j, None)
    finally:
        mp.undo()
    new_j = cppn_params_from_jax(jax.tree.map(np.asarray, state_j1.params))
    old_t = cppn_params_from_jax(params0)
    grads_j = cppn_params_from_jax(jax.tree.map(np.asarray, grads_j))
    # the first Adam step moves each parameter with a gradient by about
    # -lr sign(g), the field at coarse_lr and the shifts at pose_lr: each
    # group's move is held to a fraction of its own lr where the gradient
    # check above fixes the gradient's sign (|g| beyond its 3e-2 of the
    # max), and to the first step's largest move everywhere
    for name, p in model_t.state_dict().items():
        lr = cfg_t.pose_lr if name == "view_shifts" else cfg_t.coarse_lr
        moved = p.numpy() - old_t[name].numpy()
        moved_j = new_j[name].numpy() - old_t[name].numpy()
        g = grads_j[name].numpy()
        if not g.any():  # img1 / img2, unused by the forward: no move in either
            assert not moved.any() and not moved_j.any(), name
            continue
        sure = np.abs(g) > 3e-2 * np.abs(g).max()
        assert np.abs(moved[sure]).min() > 0.5 * lr, name
        np.testing.assert_allclose(moved[sure], moved_j[sure], atol=0.2 * lr, err_msg=name)
        assert np.abs(moved).max() <= 1.01 * lr, name


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("pose_start", [0, 3])
def test_adamw_update_of_the_shifts_matches_optax(pose_start):
    """The view shifts' AdamW group (make_optimizer with pose parameters,
    its lr pose_lr_at the device step, as the step sets it) against the
    JAX package's pose transform, optax.adamw at where(step < pose_start,
    0, pose_lr) with
    pose_weight_decay, over 8 steps of seeded gradients: unchanged while the
    lr is 0 (in both), then within one f32 ulp a step of the same rule in
    f64 (optax's own f32 bias correction 1 - 0.999^t is 5e-5 off in
    relative terms at t = 1, so optax itself lands up to ~10 ulps away), and
    each step's move within 1e-4 of optax's in relative terms (and 4 ulps
    of the shifts)."""
    cfg = TrainConfig(pose_refine=True, pose_lr=3e-2, pose_weight_decay=1e-3,
                      pose_start=pose_start)
    rng = np.random.default_rng(pose_start)
    p0 = rng.uniform(-2, 2, (5, 3)).astype(np.float32)
    tx = optax.adamw(lambda s: jnp.where(s < pose_start, 0.0, cfg.pose_lr),
                     weight_decay=cfg.pose_weight_decay)
    p_j = jnp.asarray(p0)
    opt_j = tx.init(p_j)
    model = torch.nn.Linear(1, 1)
    shifts = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = tt.make_optimizer(cfg, model.parameters(), [shifts])
    step_dev = torch.zeros((), dtype=torch.int32)
    p64, m64, v64 = p0.astype(np.float64), 0.0, 0.0
    for i in range(8):
        g = rng.normal(size=(5, 3)).astype(np.float32)
        before_j, before_t = np.asarray(p_j), shifts.detach().numpy().copy()
        upd, opt_j = tx.update(jnp.asarray(g), opt_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        shifts.grad = torch.from_numpy(g)
        sched.apply(step_dev)
        opt.param_groups[1]["lr"].copy_(tt.pose_lr_at(cfg, step_dev))
        opt.step()
        step_dev += 1
        m64 = 0.9 * m64 + 0.1 * g
        v64 = 0.999 * v64 + 0.001 * g.astype(np.float64) ** 2
        lr = 0.0 if i < pose_start else cfg.pose_lr
        adam = (m64 / (1 - 0.9 ** (i + 1))) / (np.sqrt(v64 / (1 - 0.999 ** (i + 1))) + 1e-8)
        p64 = p64 - lr * (adam + cfg.pose_weight_decay * p64)
        got = shifts.detach().numpy()
        if i < pose_start:
            assert np.array_equal(got, p0) and np.array_equal(np.asarray(p_j), p0)
            continue
        assert _ulps(got, p64.astype(np.float32)).max() <= i + 1, (i, got, p64)
        move_t, move_j = got - before_t, np.asarray(p_j) - before_j
        # the moves are differences of values near 2: 4 of their ulps beside
        np.testing.assert_allclose(move_t, move_j, rtol=1e-4,
                                   atol=4 * np.spacing(np.float32(np.abs(before_t).max())))


def test_pose_refinement_wiring():
    """The JAX test_pose_refinement_wiring on the port: view_shifts per
    view, exactly zero through the pose_start curriculum, moving after it,
    a finite loss."""
    ds = generate_dataset(make_sphere_volume(res=16), DatagenConfig(
        limited_size=90.0, number_angles=1.0, img_width=10, img_height=10, sample_outside=100.0,
        stratified_depths=False, max_shift_translation=0.05, rays_from_nominal=True),
        device="cpu")
    n_views = int(ds.rays.image_ids.max()) + 1
    cfg = TrainConfig(depth_samples_per_ray=32, sample_size=8, grid_resolution=8,
                      display_every=50, n_iters=30, early_stop_iters=10_000, coarse_lr=5e-3,
                      pose_refine=True, pose_lr=3e-2, pose_start=10, grid_update_every=100_000)
    with pytest.raises(ValueError, match="pose_refine needs num_views"):
        create_train_state(cfg, device="cpu")
    model, state = create_train_state(cfg, num_views=n_views, device="cpu")
    assert tuple(model.view_shifts.shape) == (n_views, 3)
    step = make_train_step(model, cfg, NEAR, FAR)
    for i in range(30):
        state, metrics, _, _ = step(state, ds.rays)
        if i + 1 == cfg.pose_start - 1:
            assert bool((model.view_shifts == 0).all()), "shifts moved before pose_start"
    assert float(model.view_shifts.detach().abs().max()) > 0, "shifts never moved after pose_start"
    assert np.isfinite(float(metrics["loss/train-pixel-coarse"]))


@pytest.fixture(scope="module")
def pose_rays():
    return generate_dataset(make_sphere_volume(res=16), DatagenConfig(
        limited_size=90.0, number_angles=1.0, img_width=10, img_height=10, sample_outside=100.0,
        stratified_depths=False, max_shift_translation=0.05, rays_from_nominal=True),
        device="cpu").rays


TINY = dict(depth_samples_per_ray=32, sample_size=8, grid_resolution=8, n_iters=20,
            display_every=10)


def test_tiny_pose_train(pose_rays):
    """train() with pose_refine: no carve (as the JAX loop), the shifts in
    the state, moving from pose_start, every chunk through make_train_chunk."""
    cfg = TrainConfig(**TINY, pose_refine=True, pose_start=5)
    res = train(cfg, pose_rays, 1500.0, verbose=False, device="cpu")
    shifts = res.state.model.view_shifts
    assert tuple(shifts.shape) == (5, 3) and float(shifts.abs().max()) > 0
    assert bool(res.state.grid.feasible is None or res.state.grid.feasible.all())
    assert np.isfinite(res.best_heldout_psnr) and res.iters_run == 20


def test_tiny_image_mode_train(pose_rays):
    """train() with sample_mode='image': each batch from one training view."""
    cfg = TrainConfig(**TINY, sample_mode="image")
    res = train(cfg, pose_rays, 1500.0, verbose=False, device="cpu")
    assert np.isfinite(res.best_heldout_psnr) and res.iters_run == 20
    _, state = create_train_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs num_images and rays_per_image"):
        make_train_step(state.model, cfg, NEAR, FAR)
    step = make_train_step(state.model, cfg, NEAR, FAR, num_images=4, rays_per_image=100)
    for _ in range(3):
        _, metrics, _, _ = step(state, pose_rays)
        assert np.isfinite(float(metrics["loss/train-pixel-coarse"]))


@pytest.mark.slow
def test_pose_refinement_recovers_translation():
    """The JAX slow test on the port (tests/test_training.py:352-425): a
    vessel of res 48, 24x24 views with translation shifts of 0.05 of the
    grid, rays from the nominal cameras, 900 steps with pose_start 200;
    the learned shifts' in-plane residuals after the best global gauge
    translation fall below 0.4 of the uncorrected ones on average and
    below 0.8 e0 + 0.05 in every view. The shifts are JAX's draws (key 5),
    injected."""
    dcfg = dict(limited_size=90.0, number_angles=1.0, img_width=24, img_height=24,
                sample_outside=100.0, stratified_depths=False, max_shift_translation=0.05,
                rays_from_nominal=True)
    ds_j = generate_dataset_j(make_vessel_volume_j(res=48), DatagenConfigJ(**dcfg),
                              key=jax.random.PRNGKey(5))
    mp = pytest.MonkeyPatch()
    mp.setattr(dst, "pose_shifts", _injected(ds_j))
    try:
        ds = generate_dataset(make_vessel_volume(res=48), DatagenConfig(**dcfg), device="cpu")
    finally:
        mp.undo()
    learned, gt, e0, e = recover(ds, dcfg)
    assert e.mean() < 0.4 * e0.mean(), f"aligned in-plane {e} vs initial {e0}"
    assert (e < 0.8 * e0 + 0.05).all(), f"aligned in-plane {e} vs initial {e0}"


def recover(ds, dcfg: dict, device="cpu", iters: int = 900):
    """The JAX recovery test's run and residuals on a port dataset: (learned
    shifts, injected shifts, e0, e)."""
    gt = np.stack([np.asarray(ds.proj[c], np.float64)
                   for c in ("translation_x", "translation_y", "translation_z")], -1)
    n_views = gt.shape[0]
    assert np.abs(gt[:-1]).max() > 1.0
    per = dcfg["img_width"] * dcfg["img_height"]
    dirs = ds.rays.directions.cpu().numpy().reshape(n_views, per, 3)
    d_c = dirs[:, (dcfg["img_height"] // 2) * dcfg["img_width"] + dcfg["img_width"] // 2]
    d_c = d_c / np.linalg.norm(d_c, axis=-1, keepdims=True)
    proj = np.eye(3)[None] - d_c[:, :, None] * d_c[:, None, :]

    def inplane(learned):
        r = learned - gt
        rhs = np.einsum("vij,vj->vi", proj, r)
        g, *_ = np.linalg.lstsq(proj.reshape(-1, 3), rhs.reshape(-1), rcond=None)
        return np.linalg.norm(np.einsum("vij,vj->vi", proj, r - g[None]), axis=-1)

    cfg = TrainConfig(depth_samples_per_ray=32, sample_size=24, grid_resolution=8, outside=100.0,
                      display_every=50, n_iters=iters, early_stop_iters=10_000, coarse_lr=2e-3,
                      pose_refine=True, pose_lr=3e-2, pose_start=200, grid_update_every=100_000)
    model, state = create_train_state(cfg, num_views=n_views, device=device)
    step = make_train_step(model, cfg, NEAR, FAR)
    rays = ds.rays.to(device)
    for _ in range(cfg.n_iters):
        state, metrics, _, _ = step(state, rays)
    assert np.isfinite(float(metrics["loss/train-pixel-coarse"]))
    learned = model.view_shifts.detach().cpu().numpy().astype(np.float64)
    return learned, gt, inplane(np.zeros_like(gt)), inplane(learned)


# ---------------------------------------------------------------------------
# bundles, checkpoints and Reconstruction of the new branches
# ---------------------------------------------------------------------------

BUNDLE_MODELS = {
    "view_shifts": dict(),
    "sine": dict(act_func="sine"),
    "tanh_late": dict(act_func="tanh", num_late_layers=2),
    "views": dict(num_input_channels_views=3, num_output_channels=2, pos_enc="fourier"),
    "no_bias": dict(use_bias=False),
}


@pytest.mark.parametrize("kind", list(BUNDLE_MODELS))
def test_branch_bundles_round_trip_with_jax(kind, tmp_path):
    """save_model / load_model across the packages for the new branches
    (a pose state's view_shifts, sine, tanh with late layers, the view
    branch, use_bias=False), both ways: the same flax names and values, and
    the same outputs of both CPPNs."""
    from nerf_for_angiography_tpu.models import CPPNConfig as CPPNConfigJ
    from nerf_for_angiography_tpu.models import init_cppn
    from nerf_for_angiography_tpu.training import load_model as load_model_j
    from nerf_for_angiography_tpu.training import save_model as save_model_j
    from nerf_for_angiography_tpu_torch.convert import field_params
    from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig
    from nerf_for_angiography_tpu_torch.training import load_model, save_model

    kw = dict(num_early_layers=2, num_filters=32, input_scale=0.01, **BUNDLE_MODELS[kind])
    model_j, params = init_cppn(CPPNConfigJ(**kw), jax.random.PRNGKey(2))
    params = jax.tree.map(np.asarray, params)
    if kind == "view_shifts":
        params["params"]["view_shifts"] = np.random.default_rng(3).normal(
            size=(5, 3)).astype(np.float32)
    cfg_t = CPPNConfig(**kw)
    # JAX -> port
    save_model_j(str(tmp_path / "j.npz"), CPPNConfigJ(**kw).to_model_definition(), params)
    meta, loaded = load_model(str(tmp_path / "j.npz"))
    assert meta["parameters"] == cfg_t.to_model_definition()
    model_t = CPPN(cfg_t)
    if kind == "view_shifts":
        model_t.add_view_shifts(5)
    model_t.load_state_dict(cppn_params_from_jax(loaded))
    # port -> JAX
    save_model(str(tmp_path / "t.npz"), cfg_t.to_model_definition(), model_t)
    meta_j, back = load_model_j(str(tmp_path / "t.npz"))
    assert {k: v for k, v in meta_j.items() if k != "param_keys"} == {
        k: v for k, v in meta.items() if k != "param_keys"}
    assert sorted(meta_j["param_keys"]) == sorted(meta["param_keys"])
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    n_in = 3 + kw.get("num_input_channels_views", 0)
    x = np.random.default_rng(4).uniform(-1, 1, (100, n_in)).astype(np.float32) * 100
    want = np.asarray(model_j.apply(jax.tree.map(jnp.asarray, back), jnp.asarray(x)))
    field = CPPN(cfg_t)
    field.load_state_dict(field_params(cppn_params_from_jax(back)))
    with torch.no_grad():
        np.testing.assert_allclose(field(torch.from_numpy(x)).numpy(), want, atol=1e-4)


def test_pose_state_checkpoint_restores_bit_equal(tmp_path, pose_rays):
    """CheckpointManager on a pose state: the shifts, both AdamW groups
    (state and lrs) and the pose schedule restored bit for bit."""
    from nerf_for_angiography_tpu_torch.training import CheckpointManager

    cfg = TrainConfig(**TINY, pose_refine=True, pose_start=2)
    model, state = create_train_state(cfg, num_views=5, device="cpu")
    step = make_train_step(model, cfg, NEAR, FAR)
    for _ in range(4):
        step(state, pose_rays)
    CheckpointManager(str(tmp_path)).save(4, state)
    _, fresh = create_train_state(cfg, num_views=5, device="cpu")
    fresh = CheckpointManager(str(tmp_path)).restore(fresh)
    assert fresh.step == 4 and fresh.scheduler.state_dict() == state.scheduler.state_dict()
    assert torch.equal(fresh.model.view_shifts, state.model.view_shifts)
    assert float(state.model.view_shifts.detach().abs().max()) > 0
    for ga, gb in zip(fresh.optimizer.param_groups, state.optimizer.param_groups):
        assert torch.equal(ga["lr"], gb["lr"]) and ga["weight_decay"] == gb["weight_decay"]
        for pa, pb in zip(ga["params"], gb["params"]):
            for k, v in state.optimizer.state[pb].items():
                assert torch.equal(fresh.optimizer.state[pa][k], v), k


@pytest.mark.parametrize("kind", ["pose", "sine"])
def test_reconstruction_loads_jax_pose_and_sine_runs(kind, tmp_path, pose_rays):
    """Reconstruction.from_run_dir on a JAX run directory of a pose-refined
    train(log_dir=...) (its bundle holds view_shifts) and of a sine model
    (a JAX bundle and grid VTK): the port renders the JAX Reconstruction's
    views within the render tolerance."""
    from nerf_for_angiography_tpu.evaluation import EvalConfig as EvalConfigJ
    from nerf_for_angiography_tpu.models import CPPNConfig as CPPNConfigJ
    from nerf_for_angiography_tpu.models import init_cppn
    from nerf_for_angiography_tpu.reconstruction import Reconstruction as ReconstructionJ
    from nerf_for_angiography_tpu.training import load_model as load_model_j
    from nerf_for_angiography_tpu.training import save_grid_vtk as save_grid_vtk_j
    from nerf_for_angiography_tpu.training import save_model as save_model_j
    from nerf_for_angiography_tpu.training import train as train_j
    from nerf_for_angiography_tpu_torch.evaluation import EvalConfig
    from nerf_for_angiography_tpu_torch.reconstruction import Reconstruction

    run_dir = str(tmp_path)
    if kind == "pose":
        rays = RayDataset(*(a.numpy() for a in pose_rays[:7]))
        train_j(TrainConfigJ(**TINY, num_layers=2, num_hidden_units=32, pose_refine=True,
                             pose_start=5), jax.tree.map(jnp.asarray, rays), 1500.0,
                log_dir=run_dir, verbose=False)
        assert "view_shifts" in load_model_j(f"{run_dir}/highmodel.npz")[1]["params"]
    else:
        cfg = CPPNConfigJ(num_early_layers=2, num_filters=32, act_func="sine", sine_w0=30.0,
                          input_scale=0.01)
        _, params = init_cppn(cfg, jax.random.PRNGKey(6))
        save_model_j(f"{run_dir}/highmodel.npz", cfg.to_model_definition(), params)
        state_j = create_train_state_j(TrainConfigJ(grid_resolution=8), jax.random.PRNGKey(0))[1]
        save_grid_vtk_j(f"{run_dir}/highgrid.vtk", state_j.grid)
    ev = dict(img_width=12, img_height=10, sample_outside=100.0, depth_samples_per_ray=32,
              outside=100.0)
    rec_j = ReconstructionJ.from_run_dir(run_dir, eval_config=EvalConfigJ(**ev))
    rec = Reconstruction.from_run_dir(run_dir, eval_config=EvalConfig(**ev), device="cpu")
    assert rec.meta == rec_j.meta
    assert rec.model.config.act_func == ("sine" if kind == "sine" else "relu")
    for theta, phi in ((30.0, -45.0), (90.0, 0.0)):
        np.testing.assert_allclose(rec.render_view(theta, phi), rec_j.render_view(theta, phi),
                                   atol=2e-2)
    pts = np.random.default_rng(0).uniform(-100, 100, (20, 3)).astype(np.float32)
    np.testing.assert_allclose(rec.density(pts), rec_j.density(pts), atol=2e-2)
