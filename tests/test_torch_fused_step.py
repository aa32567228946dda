"""Port: the whole-train-step gradient (fused_train_step) and the
feature-major MLP input (feature_major_mlp) against the JAX package.

The port's plain ``fused_step_grads_reference`` is held against the JAX
Pallas kernel ``fused_step_grads`` in interpret mode on the setup of
tests/test_fused_step.py (inputs from a numpy seed, weights copied across
with convert.py), with that file's tolerances; the train-step wiring
``_fused_loss_and_grads`` against the JAX one on its sphere setup, for the
dense and the two-bucket march; the feature-major path against the
point-major one (tests/test_training.py's tolerances) and against the JAX
``fused_mlp_raw_fm``."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.data import DatagenConfig as DatagenConfigJ
from nerf_for_angiography_tpu.data import generate_dataset as generate_dataset_j
from nerf_for_angiography_tpu.data import make_sphere_volume as make_sphere_volume_j
from nerf_for_angiography_tpu.models import CPPNConfig, init_cppn
from nerf_for_angiography_tpu.ops.pallas.fused_mlp import (
    cppn_params_to_list as jax_params_to_list,
)
from nerf_for_angiography_tpu.ops.pallas.fused_mlp import fused_mlp_raw_fm as jax_fused_mlp_raw_fm
from nerf_for_angiography_tpu.ops.pallas.fused_step import fused_step_grads as jax_fused_step
from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ
from nerf_for_angiography_tpu.training import create_train_state as create_train_state_j
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
from nerf_for_angiography_tpu_torch.data import DatagenConfig, generate_dataset, make_sphere_volume
from nerf_for_angiography_tpu_torch.models import CPPN
from nerf_for_angiography_tpu_torch.models import CPPNConfig as TorchCPPNConfig
from nerf_for_angiography_tpu_torch.ops import occupancy as ot
from nerf_for_angiography_tpu_torch.ops.kernels import build
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs
from nerf_for_angiography_tpu_torch.training import TrainConfig, create_train_state

# the training packages export train(), which shadows the module's name
tj = importlib.import_module("nerf_for_angiography_tpu.training.train")
tt = importlib.import_module("nerf_for_angiography_tpu_torch.training.train")

N_HIDDEN = 2
R = 700  # not a multiple of the JAX kernel's 512-ray tile
K = 7
STEP = 1.5  # large enough that early_stop_eps fires
NEAR, FAR = 1400.0, 1600.0


@pytest.fixture(scope="module")
def setup():
    """tests/test_fused_step.py's setup with the inputs drawn from a numpy
    seed: contiguous lattice windows (every active dist is STEP), 70%
    active samples, five fully masked rays."""
    _, params = init_cppn(CPPNConfig(num_early_layers=N_HIDDEN, num_filters=32),
                          jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    model = CPPN(TorchCPPNConfig(num_early_layers=N_HIDDEN, num_filters=32))
    model.load_state_dict(cppn_params_from_jax(params))
    rng = np.random.default_rng(7)
    o = (rng.standard_normal((R, 3)) * 0.3).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = rng.integers(0, 5, (R, 1)).astype(np.float32)
    t_mid = (2.0 + (start + np.arange(K, dtype=np.float32)) * STEP + 0.5 * STEP).astype(np.float32)
    mask = (rng.uniform(size=(R, K)) < 0.7).astype(np.float32)
    mask[:5] = 0.0
    targets = rng.uniform(size=R).astype(np.float32)
    return jax_params_to_list(params, N_HIDDEN), model, (o, d, t_mid, mask, targets)


def _both(setup, eps, n_loss=R, scale=1.0, arrays=None):
    """(JAX interpret-mode result, port plain-version result) on the same
    inputs; each is (pixels, [(dW, db), ...]) as numpy."""
    plist_j, model, inputs = setup
    arrays = inputs if arrays is None else arrays
    kw = dict(step=STEP, early_stop_eps=eps, n_rays_loss=n_loss, input_scale=scale)
    px_j, g_j = jax_fused_step(plist_j, *map(jnp.asarray, arrays), interpret=True, **kw)
    fs.reset_counts()
    px_t, g_t = fs.fused_step_grads(fm.cppn_params_to_list(model),
                                    *map(torch.from_numpy, arrays), **kw)
    assert fs.fused_step_launches == 0  # the plain version on the CPU
    as_np = lambda gs: [(np.asarray(w), np.asarray(b)) for w, b in gs]  # noqa: E731
    return (np.asarray(px_j), as_np(g_j)), (px_t.numpy(), as_np(g_t))


def _assert_pixels_close(got, want):
    """tests/test_fused_step.py's 1e-5, except where the two frameworks'
    f32 sums of a layer, taken in another order, round an activation to a
    neighbouring bf16 value (there the JAX test's two paths share one
    forward; here they do not): at most 0.5% of rays, each within 1e-4."""
    err = np.abs(got - want)
    assert float((err > 1e-5).mean()) <= 5e-3, err.max()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _assert_grads_close(got, want, atol=2e-4):
    """tests/test_fused_step.py's comparison: each gradient normalised by
    the max of the reference."""
    for (dw_g, db_g), (dw_w, db_w) in zip(got, want):
        for g, w in ((dw_g, dw_w), (db_g, db_w)):
            w = w.reshape(g.shape)
            s = max(np.abs(w).max(), 1e-8)
            np.testing.assert_allclose(g / s, w / s, atol=atol)


@pytest.mark.parametrize("eps", [0.0, 0.05])
def test_reference_matches_jax_kernel(setup, eps):
    (px_j, g_j), (px_t, g_t) = _both(setup, eps)
    assert px_t.shape == (R,)
    assert [w.shape for w, _ in g_t] == [(3, 32), (32, 32), (32, 32), (32, 1)]
    _assert_pixels_close(px_t, px_j)
    _assert_grads_close(g_t, g_j)


def test_input_scale_matches_jax_kernel(setup):
    (px_j, g_j), (px_t, g_t) = _both(setup, 0.01, scale=0.37)
    _assert_pixels_close(px_t, px_j)
    _assert_grads_close(g_t, g_j)


@pytest.mark.parametrize("n_loss", [R, 3 * R])
def test_loss_divisor_matches_jax_and_scales(setup, n_loss):
    (_, g_j), (_, g_t) = _both(setup, 0.0, n_loss=n_loss)
    _assert_grads_close(g_t, g_j)
    if n_loss != R:
        (_, _), (_, g_1) = _both(setup, 0.0)
        scaled = [(w / (n_loss / R), b / (n_loss / R)) for w, b in g_1]
        _assert_grads_close(g_t, scaled, atol=1e-3)  # f32 rounding of coef / 3


def test_miss_rays_give_exactly_zero_grads(setup):
    """All-masked rays render pixel 1; with target 1 they contribute
    exactly nothing, in both packages."""
    o, d, t_mid, _, _ = setup[2]
    arrays = (o, d, t_mid, np.zeros((R, K), np.float32), np.ones(R, np.float32))
    (px_j, g_j), (px_t, g_t) = _both(setup, 0.05, arrays=arrays)
    np.testing.assert_array_equal(px_t, 1.0)
    np.testing.assert_array_equal(px_j, 1.0)
    for w, b in g_t:
        assert np.abs(w).max() == 0.0 and np.abs(b).max() == 0.0


def test_reference_rejects_mismatched_shapes(setup):
    o, d, t_mid, mask, targets = map(torch.from_numpy, setup[2])
    packed = fm.pack_params(fm.cppn_params_to_list(setup[1]))
    with pytest.raises(ValueError, match="mask"):
        fs.fused_step_grads_reference(packed, o, d, t_mid, mask[:, :3], targets, step=STEP,
                                      early_stop_eps=0.0, n_rays_loss=R)


def test_kernel_wrapper_raises_without_a_build(setup, monkeypatch):
    """No fallback: asking for the kernel where it cannot be built raises."""
    o, d, t_mid, mask, targets = map(torch.from_numpy, setup[2])
    packed = fm.pack_params(fm.cppn_params_to_list(setup[1]))
    monkeypatch.setattr(fs, "_lib", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "Path", lambda p: type("P", (), {"exists": lambda self: False})())
    with pytest.raises(RuntimeError, match="nvcc"):
        fs.fused_step_grads_cuda(packed, o, d, t_mid, mask, targets, step=STEP,
                                 early_stop_eps=0.0, n_rays_loss=R)


def test_unsupported_device_raises(setup):
    t = torch.zeros((4, K), device="meta")
    with pytest.raises(ValueError, match="device"):
        fs.fused_step_grads(fm.cppn_params_to_list(setup[1]), torch.zeros((4, 3)),
                            torch.zeros((4, 3)), t, t, torch.zeros(4), step=STEP,
                            early_stop_eps=0.0, n_rays_loss=4)


def test_build_tag_covers_included_headers(tmp_path):
    """The build key hashes the source and the csrc headers it includes, so
    an edit to a shared header rebuilds every library that includes it."""
    (tmp_path / "chain.cuh").write_text("#pragma once\nint a = 1;\n")
    (tmp_path / "inner.cuh").write_text("int b = 2;\n")
    src = tmp_path / "lib.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "chain.cuh"\n  # include "inner.cuh"\n')
    tag = build.source_tag(src)
    assert tag == build.source_tag(src)
    (tmp_path / "inner.cuh").write_text("int b = 3;\n")
    tag2 = build.source_tag(src)
    assert tag2 != tag
    (tmp_path / "chain.cuh").write_text("#pragma once\nint a = 2;\n")
    assert build.source_tag(src) not in (tag, tag2)


def test_repo_sources_include_the_shared_chain():
    """Both MLP libraries build from the shared header, and their tags move
    with it."""
    for name in ("fused_mlp", "fused_step"):
        text = (build.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "mlp_chain.cuh"' in text
    assert build.source_tag(build.CSRC_DIR / "fused_mlp.cu") != build.source_tag(
        build.CSRC_DIR / "fused_step.cu")


# ---------------------------------------------------------------------------
# the train-step wiring against the JAX package (tests/test_fused_step.py's
# sphere setup, grid and weights copied across)
# ---------------------------------------------------------------------------


def _sphere(**cfg_kw):
    vol = make_sphere_volume_j(res=48, extent=75.0, radius=30.0, mu=0.02)
    data = generate_dataset_j(vol, DatagenConfigJ(
        limited_size=90.0, number_angles=2.0, img_width=24, img_height=24,
        sample_outside=100.0, stratified_depths=False,
    ))
    kw = dict(depth_samples_per_ray=32, sample_size=12, grid_resolution=8, outside=100.0,
              display_every=50, n_iters=150, early_stop_iters=10_000, coarse_lr=5e-3, **cfg_kw)
    cfg_j = TrainConfigJ(**kw)
    model_j, state_j = create_train_state_j(cfg_j, jax.random.PRNGKey(0))
    cfg_t = TrainConfig(**kw)
    model_t, _ = create_train_state(cfg_t, device="cpu")
    model_t.load_state_dict(cppn_params_from_jax(jax.tree.map(np.asarray, state_j.params)))
    g = state_j.grid
    grid_t = ot.grid_from_numpy(np.asarray(g.binary), np.asarray(g.aabb).tolist(),
                                occs=np.asarray(g.occs))
    return data, (cfg_j, model_j, state_j), (cfg_t, model_t, grid_t)


TWO_BUCKET = dict(compact_samples=16, march_mode="hybrid", hybrid_split=0.75,
                  hybrid_bucket_k=True, hybrid_k_lo=8, hybrid_w_lo=16, hybrid_w_cap=24)


@pytest.mark.parametrize("cfg_kw", [{}, TWO_BUCKET], ids=["dense", "two_bucket"])
def test_fused_loss_and_grads_matches_jax(cfg_kw):
    data, (cfg_j, model_j, state_j), (cfg_t, model_t, grid_t) = _sphere(**cfg_kw)
    o, d, tgt = (np.asarray(a)[:64] for a in (data.rays.origins, data.rays.directions,
                                               data.rays.pixel_values))
    loss_j, px_j, m_j, grads_j = tj._fused_loss_and_grads(
        model_j, state_j.params, state_j.grid, *map(jnp.asarray, (o, d, tgt)), cfg_j, NEAR, FAR)
    loss_t, px_t, m_t, grads_t = tt._fused_loss_and_grads(
        model_t, grid_t, *map(torch.from_numpy, (o, d, tgt)), cfg_t, NEAR, FAR)
    assert type(m_t).__name__ == type(m_j).__name__
    # both run the fused function at the same cast points, so tighter than
    # tests/test_fused_step.py's split-vs-fused 2e-2 / 2e-3 / 0.06
    np.testing.assert_allclose(px_t.numpy(), np.asarray(px_j), atol=1e-5)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4, abs=1e-7)
    tt._set_grads(model_t, grads_t)
    got = {n: p.grad for n, p in model_t.named_parameters()}
    for name, want in cppn_params_from_jax(jax.tree.map(np.asarray, grads_j)).items():
        if name in ("img1", "img2"):
            continue
        want = want.numpy()
        s = max(np.abs(want).max(), 1e-8)
        np.testing.assert_allclose(got[name].numpy() / s, want / s, atol=2e-4)


def test_fused_train_step_runs_on_cpu(monkeypatch):
    """fused_train_step='on' through make_train_step: one step goes through
    fused_step_grads (the plain version on the CPU), never through the
    split backward; metrics finite, parameters move."""
    ds = generate_dataset(
        make_sphere_volume(res=32, extent=75.0, radius=30.0),
        DatagenConfig(limited_size=90.0, number_angles=2.0, img_width=12, img_height=12,
                      sample_outside=100.0, stratified_depths=False),
        device="cpu",
    )
    cfg = TrainConfig(depth_samples_per_ray=32, sample_size=8, grid_resolution=8,
                      outside=100.0, num_layers=2, num_hidden_units=32, coarse_lr=5e-3,
                      compact_samples=0, fused_train_step="on")
    model, state = create_train_state(cfg, device="cpu")
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[3].shape)
        return fs.fused_step_grads(*args, **kwargs)

    def split_refused(*args, **kwargs):
        raise AssertionError("the split backward ran under fused_train_step='on'")

    monkeypatch.setattr(tt, "fused_step_grads", counted)
    monkeypatch.setattr(fm, "fused_mlp_bwd", split_refused)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = tt.make_train_step(model, cfg, NEAR, FAR)
    state, metrics, pixels, _ = step(state, ds.rays)
    assert state.step == 1 and calls == [(64, 32)]
    assert pixels.shape == (64,)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, p0[n])]
    assert "input_layer.weight" in moved and "output_linear.bias" in moved


@pytest.mark.parametrize("mode,kw,want", [
    ("off", {}, False), ("auto", {}, False), ("on", {}, True),
    ("auto", dict(train_alpha_prune=True), False), ("auto", dict(mlp_backend="xla"), False),
])
def test_fused_step_eligibility(mode, kw, want):
    """'auto' engages only on the card; 'on' forces the plain version on
    the CPU; an ineligible config keeps the split path under 'auto'."""
    cfg = TrainConfig(num_layers=2, num_hidden_units=32, fused_train_step=mode, **kw)
    assert tt._fused_step_eligible(CPPN(cfg.model_config()), cfg) is want


def test_fused_step_bad_mode_raises():
    cfg = TrainConfig(num_layers=2, num_hidden_units=32, fused_train_step="yes")
    with pytest.raises(ValueError, match="fused_train_step"):
        tt._fused_step_eligible(CPPN(cfg.model_config()), cfg)


# ---------------------------------------------------------------------------
# feature_major_mlp
# ---------------------------------------------------------------------------


def _blob_grid(res=16, seed=1):
    rng = np.random.default_rng(seed)
    idx = np.stack(np.meshgrid(*[np.arange(res) + 0.5] * 3, indexing="ij"), -1)
    binary = np.zeros((res,) * 3, bool)
    for _ in range(6):
        c = rng.uniform(0.2, 0.8, 3) * res
        r = rng.uniform(0.1, 0.2) * res
        binary |= ((idx - c) ** 2).sum(-1) < r * r
    return ot.grid_from_numpy(binary, [-100.0] * 3 + [100.0] * 3)


def _rays(n=96, seed=0):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-20, 20, (n, 2))
    o[:, 2] = 1500.0
    target = rng.uniform(-110, 110, (n, 3)).astype(np.float32)
    target[:, 2] = 0.0
    return torch.from_numpy(o), torch.from_numpy(((target - o) / 1500.0).astype(np.float32))


SMALL = dict(depth_samples_per_ray=64, grid_resolution=16, num_layers=2, num_hidden_units=32)
FM_CASES = {
    "dense": dict(compact_samples=0),
    "two_bucket": dict(march_mode="hybrid", compact_samples=24, hybrid_w_cap=48,
                       hybrid_w_lo=24, hybrid_split=0.75, hybrid_bucket_k=True,
                       hybrid_k_lo=12),
}


@pytest.mark.parametrize("case", list(FM_CASES))
def test_feature_major_matches_point_major(case):
    """The (3, P) positions recomputed from the march's t midpoints give the
    point-major path's loss and gradients (tests/test_training.py's
    tolerances: 1 ulp of position)."""
    cfg = TrainConfig(**SMALL, **FM_CASES[case])
    cfg_fm = dataclasses.replace(cfg, feature_major_mlp=True)
    model = CPPN(cfg.model_config(), generator=torch.Generator().manual_seed(0))
    grid = _blob_grid()
    o, d = _rays()
    m = tt._march_for(cfg, grid, o, d, NEAR, FAR)
    assert isinstance(m, ot.BucketedRays) == (case == "two_bucket")
    pts_fm = tt._flat_positions_fm(m, o, d)
    torch.testing.assert_close(pts_fm.T, tt._flat_positions(m), rtol=1e-6, atol=1e-4)

    def loss_and_grads(c):
        model.zero_grad(set_to_none=True)
        px, _, _ = tt.render_rays(model, grid, o, d, c, NEAR, FAR)
        loss = torch.mean((px - 0.5) ** 2)
        loss.backward()
        return float(loss), {n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    l_pm, g_pm = loss_and_grads(cfg)
    fm.reset_counts()
    l_fm, g_fm = loss_and_grads(cfg_fm)
    assert l_fm == pytest.approx(l_pm, rel=1e-5)
    assert g_fm.keys() == g_pm.keys()
    for n in g_pm:
        np.testing.assert_allclose(g_fm[n].numpy(), g_pm[n].numpy(), atol=1e-6, rtol=1e-4)


def test_density_raw_fm_matches_density_raw():
    cfg = TrainConfig(**SMALL)
    model = CPPN(cfg.model_config(), generator=torch.Generator().manual_seed(3))
    pts = torch.from_numpy(np.random.default_rng(3).uniform(-90, 90, (500, 3)).astype(np.float32))
    for backend in ("auto", "pallas", "xla"):
        got = tt.density_raw_fm(model, pts.T.contiguous(), backend)
        want = tt.density_raw(model, pts, backend)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_hidden,width,p", [(3, 64, 1001), (4, 128, 300)])
def test_fused_mlp_raw_fm_matches_jax(n_hidden, width, p):
    """The port's (3, P) entry against the JAX (8, P) one in interpret mode
    (rows 3..7 zero): forward, parameter gradients and dx (in (3, P)), with
    tests/test_torch_fused_mlp.py's tolerances."""
    _, params = init_cppn(CPPNConfig(num_early_layers=n_hidden, num_filters=width),
                          jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, params)
    for leaf in params["params"].values():
        if isinstance(leaf, dict):
            leaf["bias"] = (0.1 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    x_fm = rng.uniform(-1.0, 1.0, (3, p)).astype(np.float32)
    plist = jax_params_to_list(params, n_hidden)
    x8 = jnp.zeros((8, p), jnp.float32).at[:3].set(x_fm)

    def loss_jax(pl_, xx):
        raw = jax_fused_mlp_raw_fm(pl_, xx, True)
        return jnp.mean(jax.nn.sigmoid(raw) ** 2), raw

    (_, raw_j), (g_params, g_x) = jax.value_and_grad(loss_jax, argnums=(0, 1), has_aux=True)(
        plist, x8)

    model = CPPN(TorchCPPNConfig(num_early_layers=n_hidden, num_filters=width))
    model.load_state_dict(cppn_params_from_jax(params))
    xt = torch.from_numpy(x_fm).requires_grad_(True)
    raw_t = fm.fused_mlp_raw_fm(fm.cppn_params_to_list(model), xt)
    torch.mean(torch.sigmoid(raw_t) ** 2).backward()
    np.testing.assert_allclose(raw_t.detach().numpy(), np.asarray(raw_j), atol=2e-2, rtol=2e-2)
    assert np.median(np.abs(raw_t.detach().numpy() - np.asarray(raw_j))) < 1e-3
    for lin, (dw_j, db_j) in zip(model.linears(), g_params):
        for got, want in ((lin.weight.grad.T, dw_j), (lin.bias.grad, db_j)):
            want = np.asarray(want).reshape(got.shape)
            s = max(np.abs(want).max(), 1e-8)
            np.testing.assert_allclose(got.numpy() / s, want / s, atol=3e-2)
    assert xt.grad.shape == (3, p)
    want_dx = np.asarray(g_x)[:3]
    s = max(np.abs(want_dx).max(), 1e-8)
    np.testing.assert_allclose(xt.grad.numpy() / s, want_dx / s, atol=2e-2)


def test_fm_plain_versions_match_point_major():
    """The plain (3, P) forward and backward are the point-major ones on the
    transposed block, dx returned (3, P)."""
    model = CPPN(TorchCPPNConfig(num_early_layers=2, num_filters=32),
                 generator=torch.Generator().manual_seed(5))
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(-1, 1, (257, 3)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(257).astype(np.float32))
    x_fm = x.T.contiguous()
    torch.testing.assert_close(fm.fused_mlp_fwd(packed, x_fm, True), fm.fused_mlp_fwd(packed, x),
                               rtol=1e-6, atol=1e-6)
    grads_fm, dx_fm = fm.fused_mlp_bwd(packed, x_fm, g, True)
    grads_pm, dx_pm = fm.fused_mlp_bwd(packed, x, g)
    assert dx_fm.shape == (3, 257) and dx_fm.is_contiguous()
    torch.testing.assert_close(dx_fm, dx_pm.T, rtol=1e-5, atol=1e-6)
    for (a, b), (c, e) in zip(grads_fm, grads_pm):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(b, e, rtol=1e-5, atol=1e-6)
