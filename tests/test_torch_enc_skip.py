"""Port: the premise of kernel #4's zero-gradient tile skip, on the CPU.

The encoded backward kernel skips every 16-point tile whose upstream
gradient g is all zero (-0 counts as zero): no recompute, no encoded
features, dx left at the caller's 0 and no dA terms. That leaves every
output as it was only if those points add exact zeros: checked here on the
plain version (against the same call on the active points alone, and
against the JAX Pallas kernel pair's VJP in interpret mode), and on a CPU
fourier split step, whose composite hands the encoded MLP a g that is zero
on whole tiles and whose gradients must still match the JAX step. Inputs
come from a numpy seed; weights cross over as numpy arrays."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.models import CPPNConfig as CPPNConfigJ
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
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp_enc as fe
from nerf_for_angiography_tpu_torch.ops.sampling import RayDataset
from nerf_for_angiography_tpu_torch.training import (
    TrainConfig,
    create_train_state,
    make_train_step,
)

tj = importlib.import_module("nerf_for_angiography_tpu.training.train")

TILE = 16  # points per tile of the kernel's skip
NEAR, FAR = 1400.0, 1600.0
ALPHA = 2.7  # BARF mid-anneal

# tests/test_torch_encoding.py's limits for the plain version against the
# Pallas pair in interpret mode (the same op; ~10x its largest readings)
GRAD_NORM, DCOEFF_NORM, DX_Q99, DX_MEAN = 6e-4, 1e-5, 5e-7, 5e-8


def _setup(kind, n_basis, p, width=32, seed=0):
    """A 2 x ``width`` encoded CPPN's JAX plist with non-zero biases, the
    encoding parameters (fourier coefficients, or the BARF window at
    ALPHA) and x in [-1, 1], all from a numpy seed."""
    cfg = CPPNConfigJ(num_early_layers=2, num_filters=width, pos_enc=kind, pos_enc_basis=n_basis)
    _, params = init_cppn(cfg, jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for leaf in params["params"].values():
        if isinstance(leaf, dict):
            leaf["bias"] = (0.1 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (p, 3)).astype(np.float32)
    if kind == "fourier":
        enc = {"coeff": params["params"]["fourier_coefficients_pts"]}
    else:
        enc = {"w": np.asarray(barf_weights_j(ALPHA, barf_k_values_j(n_basis, 3)))}
    return jax_params_to_list(params, 2), enc, x


def sparse_g(p, seed=1):
    """(g (P,) f32: zero on a seeded 60% of the 16-point tiles and on a
    scattered tenth of the other points, -0 on every fifth of those zeros,
    standard normal / P elsewhere; the bool mask of the points in all-zero
    tiles)."""
    rng = np.random.default_rng(seed)
    n_tiles = -(-p // TILE)
    zero = np.zeros(n_tiles, bool)
    zero[rng.permutation(n_tiles)[: int(round(0.6 * n_tiles))]] = True
    zero = np.repeat(zero, TILE)[:p]
    g = (rng.standard_normal(p) / p).astype(np.float32)
    g[zero | (rng.random(p) < 0.1)] = 0.0
    zeros = np.flatnonzero(g == 0)
    g[zeros[::5]] = -0.0
    return g, zero


def _packed(plist_j, enc_j, kind, n_basis):
    plist = [tuple(torch.from_numpy(np.array(a)) for a in pair) for pair in plist_j]
    packed = fe.pack_enc_params(plist, n_basis)
    enc = enc_j["coeff"] if kind == "fourier" else enc_j["w"]
    a, w = fe.enc_arrays(kind, n_basis, torch.from_numpy(np.array(enc)))
    return packed, a, w


@pytest.mark.parametrize("p", [1007, 517])
@pytest.mark.parametrize("kind", ["fourier", "barf"])
def test_zero_tiles_add_exact_zeros(kind, p):
    """The plain encoded backward on a g zero on whole tiles and scattered
    points (P ragged) equals the same call on the points outside the zero
    tiles alone, every gradient and dA within 1e-5 of its max (only the f32
    summation order differs), and dx is exactly 0 on the zero tiles."""
    plist_j, enc_j, x = _setup(kind, 2, p)
    g, zero = sparse_g(p)
    packed, a, w = _packed(plist_j, enc_j, kind, 2)
    grads, da, dx = fe.fused_mlp_enc_bwd_reference(packed, a, w, torch.from_numpy(x),
                                                   torch.from_numpy(g))
    keep = ~zero
    grads_a, da_a, dx_a = fe.fused_mlp_enc_bwd_reference(
        packed, a, w, torch.from_numpy(x[keep]), torch.from_numpy(g[keep]))
    assert zero.sum() > 0.5 * p and keep.sum() > 0.3 * p
    for got, want in [*((u, v) for pair, pair_a in zip(grads, grads_a)
                        for u, v in zip(pair, pair_a)), (da, da_a)]:
        scale = max(float(want.abs().max()), 1e-30)
        torch.testing.assert_close(got / scale, want / scale, atol=1e-5, rtol=0)
    assert bool((dx[torch.from_numpy(zero)] == 0).all())
    torch.testing.assert_close(dx[torch.from_numpy(keep)], dx_a, atol=0, rtol=0)


@pytest.mark.parametrize("p", [1007, 517])
@pytest.mark.parametrize("kind", ["fourier", "barf"])
def test_sparse_g_matches_pallas_vjp(kind, p):
    """The port's encoded autograd path (the plain version on the CPU)
    against the JAX fused_mlp_enc_raw VJP (the Pallas pair in interpret
    mode) on the same sparse g at 2 x 32, L = 2: parameter gradients,
    dcoeff (fourier; the BARF window gets none) and dx within
    tests/test_torch_encoding.py's limits, and dx exactly 0 on the zero
    tiles on both sides."""
    plist_j, enc_j, x = _setup(kind, 2, p)
    g, zero = sparse_g(p, seed=2)
    spec = (kind, 2)
    _, vjp = jax.vjp(lambda pl_, e_, xx: jax_enc_raw(spec, pl_, e_, xx, True),
                     plist_j, enc_j, jnp.asarray(x))
    gp_j, genc_j, gx_j = vjp(jnp.asarray(g))
    gx_j = np.asarray(gx_j)
    assert np.all(gx_j[zero] == 0)

    plist_t = [tuple(torch.from_numpy(np.array(a)).requires_grad_(True) for a in pair)
               for pair in plist_j]
    enc_t = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in enc_j.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    fe.reset_counts()
    fe.fused_mlp_enc_raw(spec, plist_t, enc_t, xt).backward(torch.from_numpy(g))
    assert fe.enc_fwd_launches == fe.enc_bwd_launches == 0
    for (wt, bt), (wj, bj) in zip(plist_t, gp_j):
        for u, v in ((wt.grad, wj), (bt.grad, bj)):
            v = np.asarray(v).reshape(u.shape)
            scale = max(np.abs(v).max(), 1e-12)
            np.testing.assert_allclose(u.numpy() / scale, v / scale, atol=GRAD_NORM, rtol=0)
    if kind == "fourier":
        dc_j = np.asarray(genc_j["coeff"])
        scale = max(np.abs(dc_j).max(), 1e-12)
        np.testing.assert_allclose(enc_t["coeff"].grad.numpy() / scale, dc_j / scale,
                                   atol=DCOEFF_NORM, rtol=0)
    else:
        assert enc_t["w"].grad is None
        np.testing.assert_array_equal(np.asarray(genc_j["w"]), 0.0)
    dx = xt.grad.numpy()
    assert np.all(dx[zero] == 0) and np.abs(dx).max() > 0.0
    rel = np.abs(dx - gx_j) / max(np.abs(gx_j).max(), 1e-12)
    assert np.quantile(rel, 0.99) < DX_Q99 and rel.mean() < DX_MEAN


def test_all_zero_g_gives_zero_outputs():
    """g = 0 everywhere (-0 at some points): every gradient, dA and dx of
    the plain encoded backward is exactly 0, as the kernel returns them
    with every tile skipped."""
    plist_j, enc_j, x = _setup("fourier", 2, 300)
    g = np.zeros(300, np.float32)
    g[::7] = -0.0
    packed, a, w = _packed(plist_j, enc_j, "fourier", 2)
    grads, da, dx = fe.fused_mlp_enc_bwd_reference(packed, a, w, torch.from_numpy(x),
                                                   torch.from_numpy(g))
    assert all(bool((t == 0).all()) for pair in grads for t in pair)
    assert bool((da == 0).all()) and bool((dx == 0).all())


# ---------------------------------------------------------------------------
# a CPU fourier split step whose composite gradient is zero on whole tiles
# ---------------------------------------------------------------------------

SMALL = dict(
    compact_samples=0, sample_size=8, depth_samples_per_ray=32, grid_resolution=16,
    num_layers=2, num_hidden_units=32, sampling_strategy="random", coarse_lr=1e-3,
    pos_enc="fourier", early_stop_eps=0.3,
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


def test_fourier_split_step_hands_kernel4_zero_tiles_and_matches_jax(rays64, monkeypatch):
    """A fourier split step on the CPU, dense enough (output bias 3, early
    stop at 0.3) that rays stop early: the g that reaches the encoded
    backward is exactly +-0 on whole 16-point tiles (the ones the kernel
    skips) and non-zero elsewhere, and the step's gradients match the JAX
    step's (as tests/test_torch_encoding.py's step test holds them)."""
    cfg_j = TrainConfigJ(**SMALL, mlp_backend="xla", compute_dtype="bfloat16")
    model_j, state_j = create_train_state_j(cfg_j, jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.array, state_j.params)
    params0["params"]["output_linear"]["bias"][:] = 3.0
    state_j = state_j._replace(params=jax.tree.map(jnp.asarray, params0))
    rays_j = RayDatasetJ(*(None if a is None else jnp.asarray(a) for a in rays64))
    state_j1, metrics_j, _, _ = make_train_step_j(model_j, cfg_j, NEAR, FAR)(state_j, rays_j)

    def loss_fn(params):
        pix, _, _ = render_rays_j(model_j, params, state_j1.grid, rays_j.origins,
                                  rays_j.directions, cfg_j, NEAR, FAR, 0.0)
        return jnp.mean((pix - rays_j.pixel_values) ** 2)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params0))

    seen = []
    bwd = fe.fused_mlp_enc_bwd

    def recording(packed, a, w, x, g):
        seen.append(g.clone())
        return bwd(packed, a, w, x, g)

    monkeypatch.setattr(fe, "fused_mlp_enc_bwd", recording)
    cfg_t = TrainConfig(**SMALL)
    model_t, state_t = create_train_state(cfg_t, device="cpu")
    model_t.load_state_dict(cppn_params_from_jax(params0))
    state_t, metrics_t, _, _ = make_train_step(model_t, cfg_t, NEAR, FAR)(
        state_t, RayDataset(*(None if a is None else torch.from_numpy(np.array(a))
                              for a in rays64)))
    (g,) = seen
    tiles = torch.nn.functional.pad(g != 0, (0, (-g.shape[0]) % TILE)).reshape(-1, TILE)
    zero_tiles = ~tiles.any(dim=1)
    assert 0.2 < float(zero_tiles.float().mean()) < 1.0

    loss_t = float(metrics_t["loss/train-pixel-coarse"])
    assert loss_t == pytest.approx(float(metrics_j["loss/train-pixel-coarse"]), rel=2e-2)
    assert loss_t == pytest.approx(float(loss_j), rel=2e-2)
    np.testing.assert_array_equal(state_t.grid.binary.numpy(), np.asarray(state_j1.grid.binary))
    grads_t = {n: p.grad for n, p in model_t.named_parameters()}
    for name, g_j in cppn_params_from_jax(jax.tree.map(np.asarray, grads_j)).items():
        if name in ("img1", "img2"):
            assert grads_t[name] is None
            continue
        want = g_j.numpy()
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(grads_t[name].numpy() / scale, want / scale, atol=3e-2)
