"""Port: one train step against the JAX step from copied parameters, a tiny
train() on the CPU, the unported configurations, and the import rule (the
port never imports JAX or the JAX package)."""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.data import DatagenConfig as DatagenConfigJ
from nerf_for_angiography_tpu.data import generate_dataset as generate_dataset_j
from nerf_for_angiography_tpu.data import make_sphere_volume as make_sphere_volume_j
from nerf_for_angiography_tpu.ops.sampling import RayDataset as RayDatasetJ
from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ
from nerf_for_angiography_tpu.training import TrainResult as TrainResultJ
from nerf_for_angiography_tpu.training import create_train_state as create_train_state_j
from nerf_for_angiography_tpu.training import make_train_step as make_train_step_j
from nerf_for_angiography_tpu.training import render_rays as render_rays_j
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
from nerf_for_angiography_tpu_torch.data import DatagenConfig, generate_dataset, make_vessel_volume
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_for_angiography_tpu_torch.ops.sampling import RayDataset
from nerf_for_angiography_tpu_torch.training import (
    TrainConfig,
    TrainResult,
    create_train_state,
    make_train_step,
    train,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NEAR, FAR = 1400.0, 1600.0
SMALL = dict(
    compact_samples=0, sample_size=8, depth_samples_per_ray=32, grid_resolution=16,
    num_layers=2, num_hidden_units=32, sampling_strategy="random", coarse_lr=1e-3,
)


@pytest.fixture(scope="module")
def rays64():
    ds = generate_dataset_j(
        make_sphere_volume_j(res=32, extent=75.0, radius=30.0),
        DatagenConfigJ(limited_size=90.0, number_angles=1.0, img_width=8, img_height=8,
                       sample_outside=100.0, stratified_depths=False),
    )
    # one 64-ray view: with sample_size 8 the batch is the whole dataset
    r = jax.tree.map(lambda a: np.asarray(a)[:64], ds.rays._replace(sampling_table=None))
    return r


def _to_torch(r) -> RayDataset:
    return RayDataset(*(None if a is None else torch.from_numpy(np.array(a)) for a in r))


def test_train_step_matches_jax(rays64):
    cfg_j = TrainConfigJ(**SMALL, mlp_backend="xla", compute_dtype="bfloat16")
    model_j, state_j = create_train_state_j(cfg_j, jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, state_j.params)
    rays_j = RayDatasetJ(*(None if a is None else jnp.asarray(a) for a in rays64))
    step_j = make_train_step_j(model_j, cfg_j, NEAR, FAR)
    state_j1, metrics_j, _, _ = step_j(state_j, rays_j)

    # the JAX step's gradient, on the grid that step used (updated at step 0)
    def loss_fn(params):
        pix, _, _ = render_rays_j(model_j, params, state_j1.grid, rays_j.origins,
                                  rays_j.directions, cfg_j, NEAR, FAR)
        return jnp.mean((pix - rays_j.pixel_values) ** 2)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params0))

    cfg_t = TrainConfig(**SMALL)  # mlp_backend 'auto': the fused path's plain version
    model_t, state_t = create_train_state(cfg_t, device="cpu")
    model_t.load_state_dict(cppn_params_from_jax(params0))
    step_t = make_train_step(model_t, cfg_t, NEAR, FAR)
    state_t, metrics_t, _, _ = step_t(state_t, _to_torch(rays64))

    loss_t = float(metrics_t["loss/train-pixel-coarse"])
    assert loss_t == pytest.approx(float(metrics_j["loss/train-pixel-coarse"]), rel=2e-2)
    assert loss_t == pytest.approx(float(loss_j), rel=2e-2)
    np.testing.assert_array_equal(state_t.grid.binary.numpy(), np.asarray(state_j1.grid.binary))
    np.testing.assert_array_equal(state_t.vessel_grid.binary.numpy(),
                                  np.asarray(state_j1.vessel_grid.binary))
    assert state_t.step == int(state_j1.step) == 1

    new_j = cppn_params_from_jax(jax.tree.map(np.asarray, state_j1.params))
    grads_t = {n: p.grad for n, p in model_t.named_parameters()}
    for name, g_j in cppn_params_from_jax(jax.tree.map(np.asarray, grads_j)).items():
        if name in ("img1", "img2"):
            assert grads_t[name] is None  # unused by the forward, as in flax
            continue
        want = g_j.numpy()
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(grads_t[name].numpy() / scale, want / scale, atol=3e-2)
    for name, p in model_t.state_dict().items():
        # the first Adam step moves each weight by about +-lr
        np.testing.assert_allclose(p.numpy(), new_j[name].numpy(), atol=2 * cfg_t.coarse_lr)


def test_tiny_train_runs_on_cpu():
    ds = generate_dataset(
        make_vessel_volume(res=24),
        DatagenConfig(limited_size=90.0, number_angles=1.0, img_width=12, img_height=12,
                      sample_outside=100.0, stratified_depths=False),
        device="cpu",
    )
    cfg = TrainConfig(**{**SMALL, "sampling_strategy": "frangi"}, n_iters=12, display_every=6)
    fm.reset_counts()
    res = train(cfg, ds.rays, src_pt_z=1500.0, verbose=False, device="cpu")
    assert fm.fwd_launches == 0 and fm.bwd_launches == 0
    assert [f.name for f in dataclasses.fields(TrainResult)] == [
        f.name for f in dataclasses.fields(TrainResultJ)
    ]
    assert set(res.timing) == {
        "step_dense", "step_compact", "compile", "eval", "choose", "log", "export", "total",
        "other", "dense_rays", "pressure_fired", "pressure_muted", "decay_bounces",
        "steady_rays_per_sec", "tuning_final", "steady_phases",
    }
    assert res.iters_run == 12 and res.state.step == 13
    assert np.isfinite(res.best_heldout_psnr) and np.isfinite(res.last_psnr)
    assert res.timing["dense_rays"] == 13 * cfg.img_sample_size


@pytest.mark.parametrize("kw", [
    dict(num_input_channels_views=2), dict(pos_enc="fourier", pose_refine=True),
    dict(pos_enc="barf", sample_mode="image"), dict(sample_mode="image"), dict(pose_refine=True),
])
def test_unported_train_configs_raise(kw):
    """Once refused, these configurations are ported: the port's state
    holds the JAX state's parameters (names and shapes; with pose_refine
    the zero (num_views, 3) view_shifts under their own optimizer group),
    and both packages raise the same ValueError where the JAX one does:
    pose_refine without num_views, sample_mode='image' without num_images
    and rays_per_image."""
    from nerf_for_angiography_tpu.training.train import make_train_step as make_step_j

    cfg = TrainConfig(**{**SMALL, **kw})
    cfg_j = TrainConfigJ(**{**SMALL, **kw})
    if cfg.pose_refine:
        for create in (lambda: create_train_state(cfg, device="cpu"),
                       lambda: create_train_state_j(cfg_j, jax.random.PRNGKey(0))):
            with pytest.raises(ValueError, match="pose_refine needs num_views"):
                create()
    model_t, _ = create_train_state(cfg, num_views=3, device="cpu")
    model_j, state_j = create_train_state_j(cfg_j, jax.random.PRNGKey(0), num_views=3)
    want = cppn_params_from_jax(jax.tree.map(np.asarray, state_j.params))
    assert {k: tuple(v.shape) for k, v in want.items()} == {
        k: tuple(v.shape) for k, v in model_t.state_dict().items()}
    if cfg.pose_refine:
        assert not model_t.view_shifts.detach().any()
        groups = create_train_state(cfg, num_views=3, device="cpu")[1].optimizer.param_groups
        assert [len(g["params"]) for g in groups][1] == 1
    if cfg.sample_mode == "image":
        for build in (lambda: make_train_step(model_t, cfg, NEAR, FAR),
                      lambda: make_step_j(model_j, cfg_j, NEAR, FAR)):
            with pytest.raises(ValueError, match="needs num_images and rays_per_image"):
                build()
        make_train_step(model_t, cfg, NEAR, FAR, num_images=2, rays_per_image=64)


@pytest.mark.parametrize("kw", [dict(pose_refine=True), dict(train_alpha_prune=True),
                                dict(mlp_backend="xla"), dict(pos_enc="fourier"),
                                dict(pos_enc="barf")])
def test_forced_fused_step_on_an_ineligible_config_raises(kw):
    """fused_train_step='on' needs pos_enc 'none', non-differentiable
    positions, the early-stop keep only and a fused-kernel backend: the step
    builder raises ValueError otherwise, as the JAX package's does."""
    from nerf_for_angiography_tpu_torch.models import CPPN

    cfg = TrainConfig(**{**SMALL, **kw, "fused_train_step": "on"})
    with pytest.raises(ValueError, match="fused_train_step"):
        make_train_step(CPPN(cfg.model_config()), cfg, NEAR, FAR)


def test_log_dir_raises(tmp_path):
    """log_dir is ported (tests/test_torch_checkpoint.py holds its
    artifacts); a log_dir that names an existing file raises before the
    first step."""
    rays = _to_torch(jax.tree.map(np.asarray, RayDatasetJ(
        *(np.zeros((4, 3), np.float32),) * 2, *(np.ones(4, np.float32),) * 2,
        *(np.zeros(4, np.int32),) * 3,
    )))
    not_a_dir = tmp_path / "file"
    not_a_dir.write_text("")
    with pytest.raises(FileExistsError):
        train(TrainConfig(**SMALL), rays, 1500.0, log_dir=str(not_a_dir), device="cpu")


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(TrainConfig(**SMALL))


FORBIDDEN = ("jax", "flax", "optax", "pandas", "nerf_for_angiography_tpu")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*(ROOT / "nerf_for_angiography_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py",
     ROOT / "tools" / "torch_fwd_variants.py", ROOT / "tools" / "torch_enc_bwd_variants.py",
     ROOT / "tools" / "torch_lca_variants.py"]
), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"
