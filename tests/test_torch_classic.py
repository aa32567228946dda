"""Port: the classic coarse-to-fine path (training/classic.py) and the CPPN
branches it reaches, against the JAX package. One classic step (shared
model, separate fine model, view branch + BARF) against the JAX step on an
injected batch, coarse depths and fine uniforms; more CPPN branches against
flax's CPPN.apply; the JAX package's two learning tests on the port; and a
view-branch model on the grid path, which both packages refuse."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.data import DatagenConfig as DatagenConfigJ
from nerf_for_angiography_tpu.data import generate_dataset as generate_dataset_j
from nerf_for_angiography_tpu.data import make_sphere_volume as make_sphere_volume_j
from nerf_for_angiography_tpu.models import CPPNConfig as CPPNConfigJ
from nerf_for_angiography_tpu.models import init_cppn
from nerf_for_angiography_tpu.ops.sampling import RayBatch as RayBatchJ
from nerf_for_angiography_tpu.ops.sampling import RayDataset as RayDatasetJ
from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ
from nerf_for_angiography_tpu.training import create_train_state as create_train_state_j
from nerf_for_angiography_tpu.training import make_train_step as make_train_step_j
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
from nerf_for_angiography_tpu_torch.data import DatagenConfig, generate_dataset, make_sphere_volume
from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig
from nerf_for_angiography_tpu_torch.ops.sampling import RayBatch
from nerf_for_angiography_tpu_torch.training import (
    TrainConfig,
    create_classic_state,
    create_train_state,
    make_classic_train_step,
    make_train_step,
)

cj = importlib.import_module("nerf_for_angiography_tpu.training.classic")

NEAR, FAR = 1400.0, 1600.0
TINY = dict(depth_samples_per_ray=32, sample_size=8, grid_resolution=8, outside=100.0,
            display_every=50, n_iters=150, early_stop_iters=10_000, coarse_lr=5e-3,
            num_layers=2, num_hidden_units=32)
CLASSIC_CASES = {
    "shared": dict(),
    "separate_fine": dict(),
    "views_barf": dict(num_input_channels_views=3, pos_enc="barf", pos_enc_basis=4,
                       barf_start=0, barf_stop=30),
}


@pytest.fixture(scope="module")
def sphere_rays():
    ds = generate_dataset_j(
        make_sphere_volume_j(res=32, extent=75.0, radius=30.0, mu=0.02),
        DatagenConfigJ(limited_size=90.0, number_angles=1.0, img_width=12, img_height=12,
                       sample_outside=100.0, stratified_depths=False))
    return jax.tree.map(np.asarray, ds.rays._replace(sampling_table=None))


def _adam_grads(opt_state):
    """The gradient of a first optax Adam step: its first moment / (1 - b1)."""
    mu = opt_state[0].mu
    return jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)


def _assert_grads(model_t, grads_j, label):
    grads_t = {n: p.grad for n, p in model_t.named_parameters()}
    for name, g_j in cppn_params_from_jax(grads_j).items():
        if name in ("img1", "img2"):
            assert grads_t[name] is None  # unused by the forward, as in flax
            continue
        want = g_j.numpy()
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(grads_t[name].numpy() / scale, want / scale, atol=3e-2,
                                   err_msg=f"{label}: {name}")


@pytest.mark.parametrize("case", list(CLASSIC_CASES))
def test_classic_step_matches_jax(case, sphere_rays, monkeypatch):
    """One classic step on the same batch, coarse depths and fine uniforms
    in both packages (the JAX step's sampler, stratifier and uniform draw
    replaced by the injected values): the coarse and fine losses rel 2e-2,
    every gradient of both models normalised at atol 3e-2 (the JAX
    gradient read from its first Adam moment), the BARF alphas."""
    n_fine = 8
    cfg_kw = {**TINY, **CLASSIC_CASES[case]}
    cfg_j = TrainConfigJ(**cfg_kw, mlp_backend="xla")
    cfg_t = TrainConfig(**cfg_kw)
    model_j, state_j = create_train_state_j(cfg_j, jax.random.PRNGKey(0))
    fine_j = fine_params = None
    if case == "separate_fine":
        fine_j, fine_params = init_cppn(cfg_j.model_config(), jax.random.PRNGKey(7))
    params0 = jax.tree.map(np.asarray, state_j.params)
    fine0 = None if fine_params is None else jax.tree.map(np.asarray, fine_params)

    rng = np.random.default_rng(1)
    n_rays, n = cfg_t.img_sample_size, cfg_t.depth_samples_per_ray
    sel = rng.permutation(sphere_rays.origins.shape[0])[:n_rays]
    batch = [np.asarray(a)[sel] for a in (sphere_rays.origins, sphere_rays.directions,
                                          sphere_rays.pixel_values, sphere_rays.image_ids)]
    base = np.linspace(0.0, 1.0, n, dtype=np.float32)
    base = NEAR * (1.0 - base) + FAR * base
    mids = 0.5 * (base[1:] + base[:-1])
    upper, lower = np.concatenate([mids, base[-1:]]), np.concatenate([base[:1], mids])
    depths = (lower + (upper - lower) * rng.uniform(size=(n_rays, n))).astype(np.float32)
    u_fine = rng.uniform(size=(n_rays, n_fine)).astype(np.float32)

    monkeypatch.setattr(cj, "sample_pixel_rays",
                        lambda *a, **k: RayBatchJ(*(jnp.asarray(x) for x in batch)))
    monkeypatch.setattr(cj, "stratify_depths", lambda z, key: jnp.asarray(depths))
    uniform = jax.random.uniform

    def injected_uniform(key, shape=(), dtype=jnp.float32, *a, **k):
        if tuple(shape) == u_fine.shape:
            return jnp.asarray(u_fine)
        return uniform(key, shape, dtype, *a, **k)

    monkeypatch.setattr(jax.random, "uniform", injected_uniform)
    cstate_j = cj.create_classic_state(model_j, jax.tree.map(jnp.asarray, params0), cfg_j,
                                       jax.random.PRNGKey(1),
                                       fine_params=None if fine0 is None
                                       else jax.tree.map(jnp.asarray, fine0))
    step0 = 10 if case == "views_barf" else 0
    cstate_j = cstate_j._replace(step=jnp.asarray(step0, jnp.int32))
    step_j = cj.make_classic_train_step(model_j, cfg_j, NEAR, FAR, n_fine=n_fine,
                                        fine_model=fine_j)
    cstate_j1, metrics_j = step_j(cstate_j,
                                  RayDatasetJ(*(jnp.asarray(a) for a in sphere_rays[:7])))
    grads_j = _adam_grads(cstate_j1.opt_state)
    monkeypatch.undo()

    model_t, _ = create_train_state(cfg_t, device="cpu")
    model_t.load_state_dict(cppn_params_from_jax(params0))
    fine_t = None
    if fine0 is not None:
        fine_t = CPPN(cfg_t.model_config())
        fine_t.load_state_dict(cppn_params_from_jax(fine0))
    state_t = create_classic_state(model_t, cfg_t, fine_model=fine_t, device="cpu")
    state_t.step = step0
    state_t.step_dev.fill_(step0)
    step_t = make_classic_train_step(model_t, cfg_t, NEAR, FAR, n_fine=n_fine, fine_model=fine_t)
    batch_t = RayBatch(*(torch.from_numpy(np.array(a)) for a in batch))
    state_t, metrics_t = step_t.step_core(state_t, batch_t, torch.from_numpy(depths),
                                          torch.from_numpy(u_fine))

    for k in ("loss/train-pixel-coarse", "loss/train-pixel-fine"):
        assert float(metrics_t[k]) == pytest.approx(float(metrics_j[k]), rel=2e-2), k
    for k in ("barf-coarse", "barf-views-coarse"):
        assert float(metrics_t[k]) == float(metrics_j[k]), k
    if case == "views_barf":
        assert 0 < float(metrics_t["barf-coarse"]) < cfg_t.pos_enc_basis
    _assert_grads(model_t, grads_j[0], "coarse")
    if fine_t is not None:
        _assert_grads(fine_t, grads_j[1], "fine")
    assert state_t.step == step0 + 1


@pytest.fixture(scope="module")
def sphere_data_t():
    return generate_dataset(
        make_sphere_volume(res=48, extent=75.0, radius=30.0, mu=0.02),
        DatagenConfig(limited_size=90.0, number_angles=2.0, img_width=24, img_height=24,
                      sample_outside=100.0, stratified_depths=False), device="cpu")


def test_classic_hierarchical_training(sphere_data_t):
    """The JAX test_classic_hierarchical_training on the port, at 2x64 (the
    JAX test's 4x128 takes ~1 s a step on this CPU): 40 classic steps (48
    coarse + 16 fine samples) halve the fine loss; then a separate fine
    model moves on its own."""
    cfg = TrainConfig(**{**TINY, "depth_samples_per_ray": 48, "num_hidden_units": 64,
                         "sample_size": 12})
    model, _ = create_train_state(cfg, device="cpu")
    state = create_classic_state(model, cfg, device="cpu")
    step = make_classic_train_step(model, cfg, NEAR, FAR, n_fine=16)
    losses = []
    for _ in range(40):
        state, metrics = step(state, sphere_data_t.rays)
        losses.append(float(metrics["loss/train-pixel-fine"]))
    assert losses[-1] < losses[0] * 0.5 and np.isfinite(losses[-1])

    fine = CPPN(cfg.model_config(), generator=torch.Generator().manual_seed(7))
    fine0 = {k: v.clone() for k, v in fine.state_dict().items()}
    model, _ = create_train_state(cfg, device="cpu")
    state = create_classic_state(model, cfg, fine_model=fine, device="cpu")
    step = make_classic_train_step(model, cfg, NEAR, FAR, n_fine=8, fine_model=fine)
    state, metrics = step(state, sphere_data_t.rays)
    assert np.isfinite(float(metrics["loss/train-pixel-fine"]))
    assert max(float((fine.state_dict()[k] - v).abs().max()) for k, v in fine0.items()) > 0


def test_classic_viewdirs_barf_training(sphere_data_t):
    """The JAX test_classic_viewdirs_barf_training on the port, at 2x64: the
    two-head view-branch model learns the phantom through its density head,
    and both BARF alphas reach their basis by barf_stop = 30."""
    cfg = TrainConfig(**{**TINY, "depth_samples_per_ray": 48, "num_hidden_units": 64,
                         "sample_size": 12, "num_input_channels_views": 3, "pos_enc": "barf", "pos_enc_basis": 4,
                         "barf_start": 0, "barf_stop": 30})
    mc = cfg.model_config()
    assert mc.use_viewdirs and mc.num_output_channels == 2
    model, _ = create_train_state(cfg, device="cpu")
    state = create_classic_state(model, cfg, device="cpu")
    step = make_classic_train_step(model, cfg, NEAR, FAR, n_fine=16)
    losses, alphas, alphas_v = [], [], []
    for _ in range(40):
        state, metrics = step(state, sphere_data_t.rays)
        losses.append(float(metrics["loss/train-pixel-fine"]))
        alphas.append(float(metrics["barf-coarse"]))
        alphas_v.append(float(metrics["barf-views-coarse"]))
    assert losses[-1] < losses[0] * 0.5 and np.isfinite(losses[-1])
    assert alphas[0] < 1.0 and alphas[-1] == cfg.pos_enc_basis
    assert alphas_v[0] < 1.0 and alphas_v[-1] == cfg.pos_enc_basis_views


@pytest.mark.parametrize("kw", [
    dict(act_func="tanh"),
    dict(act_func="sine", num_late_layers=2),
    dict(num_late_layers=3, pos_enc="fourier", num_input_channels_views=3,
         num_output_channels=2),
    dict(use_bias=False, num_late_layers=1),
    dict(use_bias=False, num_input_channels_views=2, num_output_channels=3, act_func="tanh",
         pos_enc="barf", pos_enc_basis_views=2),
])
def test_cppn_branches_match_flax(kw):
    """More CPPN branches against flax's CPPN.apply (f32 compute) with the
    weights carried by convert.py, both ways: tanh, sine with late layers,
    the fourier view branch over late layers, use_bias=False (feature_linear
    keeps its bias, as flax's Dense does), a 2-channel rgb head."""
    kw = {"num_early_layers": 2, "num_filters": 32, "input_scale": 0.01, **kw}
    model_j, params = init_cppn(CPPNConfigJ(**kw), jax.random.PRNGKey(8))
    params = jax.tree.map(np.asarray, params)
    model_t = CPPN(CPPNConfig(**kw))
    sd = cppn_params_from_jax(params)
    assert set(sd) == set(model_t.state_dict())
    model_t.load_state_dict(sd)
    from nerf_for_angiography_tpu_torch.convert import cppn_params_to_jax

    back = cppn_params_to_jax(model_t.state_dict())["params"]
    assert jax.tree.structure(back) == jax.tree.structure(params["params"])
    n_in = 3 + kw.get("num_input_channels_views", 0)
    x = np.random.default_rng(9).uniform(-100, 100, (200, n_in)).astype(np.float32)
    want = np.asarray(model_j.apply(params, jnp.asarray(x), barf_alpha=1.7,
                                    barf_alpha_views=0.6))
    with torch.no_grad():
        got = model_t(torch.from_numpy(x), 1.7, 0.6).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_view_branch_on_the_grid_path_raises_as_jax(sphere_rays):
    """A view-branch model on the grid path (make_train_step) feeds the MLP
    3-channel positions: flax raises a parameter shape error in JAX, the
    port a ValueError that names the missing view channels."""
    cfg_kw = dict(TINY, num_input_channels_views=2)
    cfg_j = TrainConfigJ(**cfg_kw, mlp_backend="xla")
    model_j, state_j = create_train_state_j(cfg_j, jax.random.PRNGKey(0))
    rays_j = RayDatasetJ(*(jnp.asarray(a) for a in sphere_rays[:7]))
    with pytest.raises(Exception, match="views_layer"):
        make_train_step_j(model_j, cfg_j, NEAR, FAR)(state_j, rays_j)
    cfg = TrainConfig(**cfg_kw)
    model, state = create_train_state(cfg, device="cpu")
    rays_t = tuple(torch.from_numpy(np.array(a)) for a in sphere_rays[:7])
    from nerf_for_angiography_tpu_torch.ops.sampling import RayDataset

    with pytest.raises(ValueError, match="view channels"):
        make_train_step(model, cfg, NEAR, FAR)(state, RayDataset(*rays_t))


def test_classic_state_defaults_to_the_card():
    """create_classic_state, the classic path's entry point, puts the
    models on the card unless given device="cpu", and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = TrainConfig(**TINY)
    model, _ = create_train_state(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_classic_state(model, cfg)


def test_use_bias_false_through_the_fused_path():
    """A use_bias=False density model is eligible for the fused kernels by
    the JAX rule (_pallas_eligible does not read use_bias), and the JAX
    package's kernel path would look up biases it lacks; the port hands the
    kernels zero biases (cppn_params_to_list), so its fused path (the plain
    version here) computes the module's own function, and a train step runs
    with no bias gradient to write."""
    import importlib

    tt = importlib.import_module("nerf_for_angiography_tpu_torch.training.train")
    model = CPPN(CPPNConfig(num_early_layers=2, num_filters=32, use_bias=False,
                            input_scale=0.01), generator=torch.Generator().manual_seed(0))
    assert tt._pallas_eligible(model)
    pts = torch.from_numpy(np.random.default_rng(0).uniform(-100, 100, (500, 3))
                           .astype(np.float32))
    with torch.no_grad():
        fused = tt.density_raw(model, pts, backend="pallas")
        plain = tt.density_raw(model, pts, backend="xla")
    # the kernels' cast points (bf16 products, f32 sums) against an f32
    # forward: the fused-MLP tests' limits
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=2e-2)
    assert float((fused - plain).abs().median()) < 1e-3
    from nerf_for_angiography_tpu_torch.ops.occupancy import create_grid

    cfg = TrainConfig(**{**TINY, "fused_train_step": "on"})
    grid = create_grid([-100.0] * 3 + [100.0] * 3, 8)
    rng = np.random.default_rng(1)
    o = torch.tensor([[0.0, 0.0, 1500.0]]).repeat(16, 1)
    d = torch.from_numpy(np.c_[rng.uniform(-0.05, 0.05, (16, 2)), -np.ones(16)]
                         .astype(np.float32))
    tgt = torch.from_numpy(rng.uniform(0.3, 1.0, 16).astype(np.float32))
    loss, _, _, grads = tt._fused_loss_and_grads(model, grid, o, d, tgt, cfg, NEAR, FAR)
    tt._set_grads(model, grads)
    assert all(lin.bias is None and bool(torch.isfinite(lin.weight.grad).all())
               for lin in model.linears())
    assert np.isfinite(float(loss))
