"""Port: the fourier / BARF positional encodings. The BARF schedule, the CPPN
module's encoded forward against flax, the encoded fused-MLP kernels' plain
versions against the JAX Pallas pair in interpret mode (as
tests/test_pallas.py runs it on the CPU), the eligibility gate, one encoded
train step against the JAX step from copied weights, tiny CPU train() runs,
and the no-fallback rules of the kernel wrappers."""

import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.models import CPPN as CPPNJ
from nerf_for_angiography_tpu.models import CPPNConfig as CPPNConfigJ
from nerf_for_angiography_tpu.models import barf_alpha_schedule as barf_alpha_schedule_j
from nerf_for_angiography_tpu.models import barf_k_values as barf_k_values_j
from nerf_for_angiography_tpu.models import barf_weights as barf_weights_j
from nerf_for_angiography_tpu.models import init_cppn
from nerf_for_angiography_tpu.ops.pallas.fused_mlp import (
    cppn_params_to_list as jax_params_to_list,
)
from nerf_for_angiography_tpu.ops.pallas.fused_mlp import fused_mlp_enc_raw as jax_enc_raw
from nerf_for_angiography_tpu.ops.sampling import RayDataset as RayDatasetJ
from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ
from nerf_for_angiography_tpu.training import create_train_state as create_train_state_j
from nerf_for_angiography_tpu.training import make_train_step as make_train_step_j
from nerf_for_angiography_tpu.training import render_rays as render_rays_j
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
from nerf_for_angiography_tpu_torch.data import DatagenConfig, generate_dataset, make_vessel_volume
from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig
from nerf_for_angiography_tpu_torch.models import barf_alpha_schedule, barf_k_values, barf_weights
from nerf_for_angiography_tpu_torch.ops.kernels import build
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp_enc as fe
from nerf_for_angiography_tpu_torch.ops.sampling import RayDataset
from nerf_for_angiography_tpu_torch.training import (
    TrainConfig,
    create_train_state,
    make_train_step,
    train,
)

# the training packages export train(), which shadows the module's name
tj = importlib.import_module("nerf_for_angiography_tpu.training.train")
tt = importlib.import_module("nerf_for_angiography_tpu_torch.training.train")
loop_t = importlib.import_module("nerf_for_angiography_tpu_torch.training.loop")

L = 5
NEAR, FAR = 1400.0, 1600.0


# ---------------------------------------------------------------------------
# the BARF schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.2, 2.7, 5.0, 6.0])
def test_barf_weights_match_jax(alpha):
    k_t, k_j = barf_k_values(L, 3), np.asarray(barf_k_values_j(L, 3))
    np.testing.assert_array_equal(k_t.numpy(), k_j)
    want = np.asarray(barf_weights_j(alpha, jnp.asarray(k_j)))
    got = barf_weights(alpha, k_t).numpy()
    assert got.dtype == np.float32
    # within one f32 ulp of cos
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("step", [0, 50, 175, 300, 10_000])
def test_barf_alpha_schedule_matches_jax(step):
    """0 at barf_start, the ramp's middle, barf_stop and beyond."""
    got = barf_alpha_schedule(step, L, barf_start=50, barf_stop=300)
    want = float(barf_alpha_schedule_j(step, L, barf_start=50, barf_stop=300))
    assert abs(got - want) <= 1e-6
    assert got == float(np.float32(got))  # an f32 value


# ---------------------------------------------------------------------------
# the CPPN module
# ---------------------------------------------------------------------------


def _pair(kind, dtype_j=jnp.float32, dtype_t=torch.float32, n_hidden=2, width=64, seed=3):
    cfg_j = CPPNConfigJ(num_early_layers=n_hidden, num_filters=width, input_scale=0.01,
                        pos_enc=kind, pos_enc_basis=L, dtype=dtype_j)
    model_j, params = init_cppn(cfg_j, jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    model_t = CPPN(CPPNConfig(num_early_layers=n_hidden, num_filters=width, input_scale=0.01,
                              pos_enc=kind, pos_enc_basis=L, dtype=dtype_t))
    model_t.load_state_dict(cppn_params_from_jax(params))
    return model_j, params, model_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,alpha", [("fourier", 0.0), ("barf", 0.0), ("barf", 2.7),
                                        ("barf", 5.0)])
def test_cppn_encoded_forward_matches_flax(kind, alpha, dtype):
    model_j, params, model_t = _pair(kind, getattr(jnp, dtype), getattr(torch, dtype))
    x = np.random.default_rng(0).uniform(-100, 100, (500, 3)).astype(np.float32)
    want = np.asarray(model_j.apply(params, jnp.asarray(x), barf_alpha=alpha))
    with torch.no_grad():
        got = model_t(torch.from_numpy(x), alpha).numpy()
    assert got.shape == want.shape == (500, 1)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_state_dict_names_match_flax_fourier():
    """The fourier coefficients carry across by convert.py, by name."""
    _, params, model_t = _pair("fourier")
    sd = model_t.state_dict()
    assert set(cppn_params_from_jax(params)) == set(sd)
    assert sd["fourier_coefficients_pts"].shape == (3 * L,)
    np.testing.assert_array_equal(sd["fourier_coefficients_pts"].numpy(),
                                  params["params"]["fourier_coefficients_pts"])
    assert model_t.input_layer.weight.shape == (64, 3 + 6 * L)


def test_fourier_init_matches_flax_in_distribution():
    """N(0, fourier_sigma^2) coefficients, as flax draws them."""
    cfg = CPPNConfig(pos_enc="fourier", pos_enc_basis=200, fourier_sigma=5.0)
    c = CPPN(cfg, generator=torch.Generator().manual_seed(0)).fourier_coefficients_pts
    assert c.shape == (600,) and c.requires_grad
    assert abs(float(c.detach().std()) - 5.0) < 0.5 and abs(float(c.detach().mean())) < 0.6
    assert not hasattr(CPPN(dataclasses.replace(cfg, pos_enc_basis=0)),
                       "fourier_coefficients_pts")


# ---------------------------------------------------------------------------
# the encoded fused-MLP kernels' plain versions against the JAX Pallas pair
# ---------------------------------------------------------------------------


def _enc_setup(kind, n_basis, p, alpha=2.7, seed=0):
    """Weights with non-zero biases (flax init + numpy), x in [-1, 1], the
    cotangent g, and the encoding parameters, all from a numpy seed."""
    cfg = CPPNConfigJ(num_early_layers=2, num_filters=64, pos_enc=kind, pos_enc_basis=n_basis)
    _, params = init_cppn(cfg, jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for leaf in params["params"].values():
        if isinstance(leaf, dict):
            leaf["bias"] = (0.1 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (p, 3)).astype(np.float32)
    g = (rng.standard_normal(p) / p).astype(np.float32)
    if kind == "fourier":
        enc = {"coeff": params["params"]["fourier_coefficients_pts"]}
    else:
        enc = {"w": np.asarray(barf_weights_j(alpha, barf_k_values_j(n_basis, 3)))}
    return jax_params_to_list(params, 2), enc, x, g


# The plain version shares the Pallas kernels' cast points, so the limits
# are about 10x the largest reading over these cases (forward 8.9e-5 / 1.5e-8
# of the output scale s = max(1, max |raw|) at max / median, gradients 5.7e-5
# and dcoeff 6.2e-7 of their max, dx 4.7e-8 / 5.3e-9 at the 99th percentile /
# mean), far inside the JAX tests' own (2e-2 s, 3e-2, 5e-2 / 1e-2): a bf16
# rounding of an encoded feature or activation that flips between the two
# sides moves the forward by up to ~1e-4 s.
FWD_MAX, FWD_MEDIAN, GRAD_NORM, DCOEFF_NORM, DX_Q99, DX_MEAN = 1e-3, 2e-7, 6e-4, 1e-5, 5e-7, 5e-8


# KE 16 and 48 at two point counts; KE 32 and 64 (n_basis 3 and 10) at the
# ragged one, so that the plain version meets JAX at every encoded width the
# kernels take (the card tests hold each kernel to the plain version)
@pytest.mark.parametrize("kind,n_basis,p", [
    *((kind, n_basis, p) for p in (2500, 1237) for n_basis in (2, 5)
      for kind in ("fourier", "barf")),
    *((kind, n_basis, 1237) for n_basis in (3, 10) for kind in ("fourier", "barf")),
])
def test_plain_enc_matches_pallas_interpret(kind, n_basis, p):
    plist_j, enc_j, x, g = _enc_setup(kind, n_basis, p)
    spec = (kind, n_basis)
    jx = jnp.asarray(x)
    raw_j, vjp = jax.vjp(lambda pl_, e_, xx: jax_enc_raw(spec, pl_, e_, xx, True),
                         plist_j, enc_j, jx)
    gp_j, genc_j, gx_j = vjp(jnp.asarray(g))

    plist_t = [tuple(torch.from_numpy(np.array(a)).requires_grad_(True) for a in pair)
               for pair in plist_j]
    enc_t = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in enc_j.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    raw_t = fe.fused_mlp_enc_raw(spec, plist_t, enc_t, xt)
    raw_t.backward(torch.from_numpy(g))

    want = np.asarray(raw_j)
    got = raw_t.detach().numpy()
    assert got.shape == want.shape == (p,)
    s = max(1.0, np.abs(want).max())
    err = np.abs(got - want)
    assert err.max() <= FWD_MAX * s and np.median(err) <= FWD_MEDIAN * s, (err.max(),
                                                                            np.median(err))
    for (wt, bt), (wj, bj) in zip(plist_t, gp_j):
        for a, b in ((wt.grad, wj), (bt.grad, bj)):
            b = np.asarray(b).reshape(a.shape)
            scale = max(np.abs(b).max(), 1e-12)
            np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=GRAD_NORM, rtol=0)
    if kind == "fourier":
        dc_j = np.asarray(genc_j["coeff"])
        scale = max(np.abs(dc_j).max(), 1e-12)
        np.testing.assert_allclose(enc_t["coeff"].grad.numpy() / scale, dc_j / scale,
                                   atol=DCOEFF_NORM, rtol=0)
    else:
        # the window is a schedule: no gradient (JAX returns zeros)
        assert enc_t["w"].grad is None
        np.testing.assert_array_equal(np.asarray(genc_j["w"]), 0.0)
    # dx, per point: the JAX test's rule (tests/test_pallas.py:309-315)
    dx_j = np.asarray(gx_j)
    rel = np.abs(xt.grad.numpy() - dx_j) / max(np.abs(dx_j).max(), 1e-12)
    assert np.abs(xt.grad.numpy()).max() > 0.0
    assert np.quantile(rel, 0.99) < DX_Q99 and rel.mean() < DX_MEAN, (np.quantile(rel, 0.99),
                                                                      rel.mean())


def test_kernel_columns_and_packing():
    """The JAX feature order [x, sin rows, cos rows] maps onto the kernels'
    pair order, W_in's rows follow it, and the gradient maps back."""
    cols = fe.kernel_columns(L)
    assert fe.enc_width(L) == 48 and fe.enc_width(2) == 16 and fe.enc_width(10) == 64
    assert cols[:3].tolist() == [0, 1, 2]
    assert cols[3:6].tolist() == [4, 6, 8] and cols[3 + 3 * L].item() == 5
    assert sorted(cols.tolist()) == sorted(set(cols.tolist()))  # one column each
    w_in = torch.arange(33 * 16, dtype=torch.float32).reshape(33, 16) / 512
    plist = [(w_in, torch.zeros(16)), (torch.zeros(16, 1), torch.zeros(1))]
    packed = fe.pack_enc_params(plist, L)
    assert packed.w_in.shape == (16, 48)
    torch.testing.assert_close(packed.w_in[:, cols].float().T, w_in.bfloat16().float())
    assert float(packed.w_in[:, 3].abs().max()) == 0.0
    assert float(packed.w_in[:, 34:].abs().max()) == 0.0
    grads, _ = fe.to_plist_grads([(packed.w_in.float().T, torch.zeros(16)), plist[1]],
                                 torch.zeros(48), "barf", L)
    torch.testing.assert_close(grads[0][0], w_in.bfloat16().float())


# ---------------------------------------------------------------------------
# the eligibility gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["relu", "sine"])
@pytest.mark.parametrize("basis", [0, 5])
@pytest.mark.parametrize("kind", ["none", "fourier", "barf"])
def test_pallas_eligible_matches_jax(kind, basis, act):
    want = tj._pallas_eligible(CPPNJ(CPPNConfigJ(pos_enc=kind, pos_enc_basis=basis,
                                                 act_func=act)))
    # the port's module refuses sine at construction; the gate reads only
    # the config
    stand_in = types.SimpleNamespace(config=CPPNConfig(pos_enc=kind, pos_enc_basis=basis,
                                                       act_func=act))
    assert tt._pallas_eligible(stand_in) == want


# ---------------------------------------------------------------------------
# one encoded train step against the JAX step, and tiny train() runs
# ---------------------------------------------------------------------------

SMALL = dict(
    compact_samples=0, sample_size=8, depth_samples_per_ray=32, grid_resolution=16,
    num_layers=2, num_hidden_units=32, sampling_strategy="random", coarse_lr=1e-3,
)


@pytest.fixture(scope="module")
def rays64():
    from nerf_for_angiography_tpu.data import DatagenConfig as DatagenConfigJ
    from nerf_for_angiography_tpu.data import generate_dataset as generate_dataset_j
    from nerf_for_angiography_tpu.data import make_sphere_volume as make_sphere_volume_j

    ds = generate_dataset_j(
        make_sphere_volume_j(res=32, extent=75.0, radius=30.0),
        DatagenConfigJ(limited_size=90.0, number_angles=1.0, img_width=8, img_height=8,
                       sample_outside=100.0, stratified_depths=False),
    )
    # one 64-ray view: with sample_size 8 the batch is the whole dataset
    return jax.tree.map(lambda a: np.asarray(a)[:64], ds.rays._replace(sampling_table=None))


@pytest.mark.parametrize("kind", ["fourier", "barf"])
def test_encoded_train_step_matches_jax(rays64, kind):
    """As test_torch_train.py::test_train_step_matches_jax, for an encoded
    model: BARF at step 3 of a 0..8 anneal (alpha 1.875) with a grid update
    at that step, so the window reaches the grid pass and the step."""
    extra = dict(pos_enc=kind)
    if kind == "barf":
        extra.update(barf_start=0, barf_stop=8, grid_update_every=3)
    step0 = 3 if kind == "barf" else 0
    cfg_j = TrainConfigJ(**SMALL, **extra, mlp_backend="xla", compute_dtype="bfloat16")
    model_j, state_j = create_train_state_j(cfg_j, jax.random.PRNGKey(0))
    state_j = state_j._replace(step=jnp.asarray(step0, jnp.int32))
    params0 = jax.tree.map(np.asarray, state_j.params)
    rays_j = RayDatasetJ(*(None if a is None else jnp.asarray(a) for a in rays64))
    state_j1, metrics_j, _, _ = make_train_step_j(model_j, cfg_j, NEAR, FAR)(state_j, rays_j)
    alpha_j = float(metrics_j["barf-coarse"])
    assert alpha_j == (1.875 if kind == "barf" else 0.0)

    def loss_fn(params):
        pix, _, _ = render_rays_j(model_j, params, state_j1.grid, rays_j.origins,
                                  rays_j.directions, cfg_j, NEAR, FAR, alpha_j)
        return jnp.mean((pix - rays_j.pixel_values) ** 2)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params0))

    cfg_t = TrainConfig(**SMALL, **extra)  # mlp_backend 'auto': the encoded kernels' plain version
    model_t, state_t = create_train_state(cfg_t, device="cpu")
    model_t.load_state_dict(cppn_params_from_jax(params0))
    state_t.step = step0
    fe.reset_counts()
    state_t, metrics_t, _, _ = make_train_step(model_t, cfg_t, NEAR, FAR)(
        state_t, RayDataset(*(None if a is None else torch.from_numpy(np.array(a))
                              for a in rays64)))
    assert fe.enc_fwd_launches == 0 and fe.enc_bwd_launches == 0
    assert float(metrics_t["barf-coarse"]) == alpha_j

    loss_t = float(metrics_t["loss/train-pixel-coarse"])
    assert loss_t == pytest.approx(float(metrics_j["loss/train-pixel-coarse"]), rel=2e-2)
    assert loss_t == pytest.approx(float(loss_j), rel=2e-2)
    np.testing.assert_array_equal(state_t.grid.binary.numpy(), np.asarray(state_j1.grid.binary))
    np.testing.assert_array_equal(state_t.vessel_grid.binary.numpy(),
                                  np.asarray(state_j1.vessel_grid.binary))
    assert state_t.step == int(state_j1.step) == step0 + 1

    grads_t = {n: p.grad for n, p in model_t.named_parameters()}
    g_names = set(cppn_params_from_jax(jax.tree.map(np.asarray, grads_j)))
    assert ("fourier_coefficients_pts" in g_names) == (kind == "fourier")
    for name, g_j in cppn_params_from_jax(jax.tree.map(np.asarray, grads_j)).items():
        if name in ("img1", "img2"):
            assert grads_t[name] is None  # unused by the forward, as in flax
            continue
        want = g_j.numpy()
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(grads_t[name].numpy() / scale, want / scale, atol=3e-2)
    new_j = cppn_params_from_jax(jax.tree.map(np.asarray, state_j1.params))
    for name, p in model_t.state_dict().items():
        # the first Adam step moves each parameter by about +-lr
        np.testing.assert_allclose(p.numpy(), new_j[name].numpy(), atol=2 * cfg_t.coarse_lr)


@pytest.fixture(scope="module")
def vessel_rays():
    ds = generate_dataset(
        make_vessel_volume(res=48, extent=40.0),
        DatagenConfig(limited_size=180.0, number_angles=4.0, img_width=48, img_height=48,
                      sample_outside=50.0, stratified_depths=False),
        device="cpu",
    )
    return ds.rays


TINY = dict(depth_samples_per_ray=200, sample_size=12, grid_resolution=32, outside=50.0,
            num_layers=2, num_hidden_units=32, display_every=10)


def test_tiny_fourier_train_engages_compaction_on_cpu(vessel_rays, capsys):
    """train() with fourier at the compaction defaults (sizes cut) engages
    the compacted stepper, trains the coefficients and launches nothing on
    the CPU."""
    cfg = TrainConfig(**TINY, n_iters=20, pos_enc="fourier")
    fe.reset_counts()
    fm.reset_counts()
    res = train(cfg, vessel_rays, src_pt_z=1500.0, verbose=True, device="cpu")
    assert "switching to compacted stepper at iter 0" in capsys.readouterr().out
    assert fe.enc_fwd_launches == fe.enc_bwd_launches == fm.fwd_launches == 0
    assert sum(p["steps"] for p in res.timing["steady_phases"]) == 20
    assert np.isfinite(res.best_heldout_psnr) and np.isfinite(res.last_psnr)
    model = res.state.model
    init = CPPN(cfg.model_config(), generator=torch.Generator().manual_seed(cfg.seed))
    assert not torch.equal(model.fourier_coefficients_pts.detach(),
                           init.fourier_coefficients_pts.detach())


def test_tiny_barf_train_anneals_alpha(vessel_rays, monkeypatch):
    """train() with BARF: every step's "barf-coarse" (the eager steps' and
    each step of the chunks') is the schedule at its step, rising from 0 to
    L and staying there; eval runs at the state's alpha."""
    seen = []

    def recorded(step):
        def run(state, rays):
            out = step(state, rays)
            seen.append(float(out[1]["barf-coarse"]))
            return out

        return run

    def recording_chunk(make):
        def wrapped(*args, **kwargs):
            chunk = make(*args, **kwargs)
            chunk.step = recorded(chunk.step)
            return chunk

        return wrapped

    monkeypatch.setattr(loop_t, "make_train_chunk", recording_chunk(loop_t.make_train_chunk))
    cfg = TrainConfig(**TINY, n_iters=12, pos_enc="barf", barf_start=2, barf_stop=10)
    res = train(cfg, vessel_rays, src_pt_z=1500.0, verbose=False, device="cpu")
    want = [float(barf_alpha_schedule_j(s, L, 2, 10)) for s in range(13)]
    assert seen == pytest.approx(want, abs=1e-6)
    assert seen[0] == 0.0 and seen[-1] == float(L) and 0.0 < seen[5] < float(L)
    assert np.isfinite(res.last_psnr)


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def packed_enc():
    plist_j, enc, x, g = _enc_setup("fourier", L, 300)
    plist = [tuple(torch.from_numpy(np.array(a)) for a in pair) for pair in plist_j]
    packed = fe.pack_enc_params(plist, L)
    a, w = fe.enc_arrays("fourier", L, torch.from_numpy(np.array(enc["coeff"])))
    return packed, a, w, torch.from_numpy(x), torch.from_numpy(g), plist


def test_enc_cpu_tensors_never_launch(packed_enc):
    _, a, w, x, g, plist = packed_enc
    fe.reset_counts()
    coeff = (a / (2 * np.pi)).requires_grad_(True)
    out = fe.fused_mlp_enc_raw(("fourier", L), plist, {"coeff": coeff}, x)
    out.sum().backward()
    assert fe.enc_fwd_launches == 0 and fe.enc_bwd_launches == 0
    assert coeff.grad is not None and coeff.grad.shape == (3 * L,)


def test_enc_kernel_wrapper_raises_without_a_build(packed_enc, monkeypatch):
    """No fallback: asking for the kernel where it cannot be built raises."""
    packed, a, w, x, g, _ = packed_enc
    monkeypatch.setattr(fe, "_lib", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "Path", lambda p: type("P", (), {"exists": lambda self: False})())
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.fused_mlp_enc_fwd_cuda(packed, a, w, x)
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.fused_mlp_enc_bwd_cuda(packed, a, w, x, g)


def test_enc_unsupported_device_raises(packed_enc):
    packed, a, w, _, g, _ = packed_enc
    with pytest.raises(ValueError):
        fe.fused_mlp_enc_fwd(packed, a, w, torch.zeros((4, 3), device="meta"))
    with pytest.raises(ValueError):
        fe.fused_mlp_enc_bwd(packed, a, w, torch.zeros((4, 3), device="meta"),
                             torch.zeros((4,), device="meta"))
