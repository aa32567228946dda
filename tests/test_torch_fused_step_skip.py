"""Port: the premise of the whole-step kernel's draw gate, on the CPU.

On the card the whole-step kernel (fused_train_step) computes the forward
only on 16-sample tiles of the flat (R k) march that hold a sample with
mask != 0, and the MLP backward only on tiles that hold a sample with draw
!= 0. That leaves the pixels and gradients as they were only if every
sample with draw 0 adds exact zeros: checked here on the plain version
(against the JAX Pallas kernel in interpret mode, and against itself and
JAX with the positions of the samples whose keep is 0 moved) on marches
built to exercise the skip: whole 16-sample tiles masked out, rays cut
short by the early stop, an all-zero ray, k = 56 and k = 300 (tiles cross
ray boundaries) and R k not a multiple of 16. Inputs come from a numpy
seed; weights cross over with convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.models import CPPNConfig, init_cppn
from nerf_for_angiography_tpu.ops.pallas.fused_mlp import (
    cppn_params_to_list as jax_params_to_list,
)
from nerf_for_angiography_tpu.ops.pallas.fused_step import fused_step_grads as jax_fused_step
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
from nerf_for_angiography_tpu_torch.models import CPPN
from nerf_for_angiography_tpu_torch.models import CPPNConfig as TorchCPPNConfig
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs
from test_torch_fused_step import _assert_grads_close, _assert_pixels_close

TILE = 16  # samples a tile of the kernel's skip
N_HIDDEN, WIDTH = 2, 32
EPS = 1e-2
B_OUT = 2.0  # sigma ~ 0.9 a sample: most rays stop well before their last sample
# (R, k, step): R k % 16 = 8 and 12, neither k a multiple of 16; positions
# within ~30 of the origin, as in tests/test_torch_fused_step.py
CASES = {"k56": (37, 56, 0.4), "k300": (29, 300, 0.06)}


def skip_march(r, k, step, seed=0):
    """Rays, depth-ascending midpoints one ``step`` apart, a 70% mask with a
    third of the flat 16-sample tiles and ray 0 all zero, and targets."""
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((r, 3)) * 0.3).astype(np.float32)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = rng.integers(0, 5, (r, 1)).astype(np.float32)
    t_mid = (2.0 + (start + np.arange(k, dtype=np.float32) + 0.5) * step).astype(np.float32)
    mask = (rng.uniform(size=(r, k)) < 0.7).astype(np.float32)
    flat = mask.reshape(-1)
    n_tiles = -(-flat.size // TILE)
    for tile in rng.permutation(n_tiles)[: n_tiles // 3]:
        flat[tile * TILE:(tile + 1) * TILE] = 0.0
    mask[0] = 0.0
    targets = rng.uniform(size=r).astype(np.float32)
    return o, d, t_mid, mask, targets


@pytest.fixture(scope="module")
def weights():
    """JAX params (output bias B_OUT) as the JAX kernel's list and as the
    port's CPPN."""
    _, params = init_cppn(CPPNConfig(num_early_layers=N_HIDDEN, num_filters=WIDTH),
                          jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    params["params"]["output_linear"]["bias"] = np.full((1,), B_OUT, np.float32)
    model = CPPN(TorchCPPNConfig(num_early_layers=N_HIDDEN, num_filters=WIDTH))
    model.load_state_dict(cppn_params_from_jax(params))
    return jax_params_to_list(params, N_HIDDEN), model


def kw_of(step, arrays):
    return dict(step=step, early_stop_eps=EPS, input_scale=1.0, n_rays_loss=arrays[0].shape[0])


def port(model, step, arrays, with_draws=False):
    """The port's plain version on numpy arrays: (pixels, grads as numpy),
    and with ``with_draws`` also (draws (R, k), sigma (R, k))."""
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    tensors = [torch.from_numpy(a) for a in arrays]
    kw = kw_of(step, arrays)
    px, grads = fs.fused_step_grads_reference(packed, *tensors, **kw)
    out = (px.numpy(), [(w.numpy(), b.numpy()) for w, b in grads])
    if not with_draws:
        return out
    _, draw, _, acts = fs.draws_reference(packed, *tensors, **kw)
    sigma = torch.sigmoid(fm._head(packed, acts)).reshape(draw.shape)
    return out + (draw.numpy(), sigma.numpy())


def jax_ref(plist, step, arrays):
    px, grads = jax_fused_step(plist, *map(jnp.asarray, arrays), interpret=True,
                               **kw_of(step, arrays))
    return np.asarray(px), [(np.asarray(w), np.asarray(b)) for w, b in grads]


def tiles_with(flags):
    """The flat 16-sample tiles holding a True sample (the last tile
    ragged)."""
    flat = flags.reshape(-1)
    flat = np.concatenate([flat, np.zeros((-flat.size) % TILE, bool)])
    return flat.reshape(-1, TILE).any(axis=1)


def stopped(sigma, mask, step):
    """Samples past their ray's early stop by a margin: the exclusive
    transmittance of the active samples before them below EPS / 2, so their
    keep is 0 whatever the order of the sum."""
    tau = (sigma * (step * mask)).astype(np.float64)
    t_excl = np.exp(-(np.cumsum(tau, axis=1) - tau))
    return (mask != 0) & (t_excl < EPS / 2)


@pytest.mark.parametrize("case", list(CASES))
def test_march_exercises_the_skip(weights, case):
    """Each march has whole masked tiles, an all-zero ray, rays cut short
    by the early stop and mask-active tiles whose draws are all zero; the
    draw-active tiles are a subset of the mask-active ones."""
    r, k, step = CASES[case]
    arrays = skip_march(r, k, step)
    mask = arrays[3]
    _, _, draw, sigma = port(weights[1], step, arrays, with_draws=True)
    by_mask, by_draw = tiles_with(mask != 0), tiles_with(draw != 0)
    assert (r * k) % TILE != 0 and k % TILE != 0
    assert not by_mask.all() and not mask[0].any()
    assert stopped(sigma, mask, step).any(axis=1).mean() > 0.5
    assert not (by_draw & ~by_mask).any()
    assert (by_mask & ~by_draw).sum() > 0.1 * by_mask.sum()


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_jax_on_skip_marches(weights, case):
    """The plain version against the JAX kernel in interpret mode with
    tests/test_torch_fused_step.py's limits; the all-zero ray renders 1."""
    step = CASES[case][2]
    arrays = skip_march(*CASES[case])
    px_j, g_j = jax_ref(weights[0], step, arrays)
    px_t, g_t = port(weights[1], step, arrays)
    _assert_pixels_close(px_t, px_j)
    _assert_grads_close(g_t, g_j)
    assert px_t[0] == 1.0 and px_j[0] == 1.0


@pytest.mark.parametrize("case", list(CASES))
def test_keep_zero_samples_add_exact_zeros(weights, case):
    """Moving the samples whose keep is 0 (masked, or past the early stop)
    to other positions leaves every pixel and gradient equal, but for the
    sign of a zero, in the port's plain version and in the JAX kernel: their
    draws are 0, so they add exact zeros, which the kernel's gate relies
    on. Whole tiles of them exist, so the gate skips tiles."""
    plist, model = weights
    step = CASES[case][2]
    arrays = skip_march(*CASES[case])
    o, d, t_mid, mask, tgt = arrays
    px, grads, draw, sigma = port(model, step, arrays, with_draws=True)
    moved = (mask == 0) | stopped(sigma, mask, step)
    assert (draw[moved] == 0).all()
    assert (tiles_with(mask != 0) & ~tiles_with(~moved)).any()
    rng = np.random.default_rng(9)
    t_moved = np.where(moved, rng.uniform(2.0, 2.0 + k_span(t_mid), t_mid.shape),
                       t_mid).astype(np.float32)
    assert (t_moved != t_mid)[moved].all()
    px2, grads2 = port(model, step, (o, d, t_moved, mask, tgt))
    np.testing.assert_array_equal(px2, px)
    for (w, b), (w2, b2) in zip(grads, grads2):
        np.testing.assert_array_equal(w2, w)
        np.testing.assert_array_equal(b2, b)
    px_j, g_j = jax_ref(plist, step, arrays)
    px_j2, g_j2 = jax_ref(plist, step, (o, d, t_moved, mask, tgt))
    np.testing.assert_array_equal(px_j2, px_j)
    for (w, b), (w2, b2) in zip(g_j, g_j2):
        np.testing.assert_array_equal(w2, w)
        np.testing.assert_array_equal(b2, b)


def k_span(t_mid):
    return float(t_mid.max() - t_mid.min()) + 1.0


class _FakeLib:
    """The C interface of csrc/fused_step.cu, recording its calls."""

    def __init__(self):
        self.calls = []

    def fused_step_sizes(self, f, nh, n_sms, out):
        n = 16 * f + nh * f * f + (nh + 1) * f + f + 1  # csrc/mlp_chain.cuh GradLayout
        out[0], out[1], out[2], out[3], out[4] = 1024, -(-n // 64) * 64, n, n_sms * 256, 64

    def fused_step_scratch_rows(self, p):
        self.calls.append(("rows", p))
        return -(-p // TILE) * TILE

    def fused_step_grads(self, *args):
        self.calls.append(("grads", args))
        return 0


def test_wrapper_sizes_the_scratch_by_the_rows_entry_point(weights, monkeypatch):
    """The wrapper asks the library for the rows of the tile-fragment
    scratch (P rounded up to whole tiles) and allocates acts and dz with
    them."""
    r, k, step = CASES["k56"]
    arrays = [torch.from_numpy(a) for a in skip_march(r, k, step)]
    lib = _FakeLib()
    made = []
    make = fm.BwdScratch.make

    def recording(*args, **kwargs):
        s = make(*args, **kwargs)
        made.append(s)
        return s

    monkeypatch.setattr(fs, "_lib", lib)
    monkeypatch.setattr(fm, "_num_sms", lambda dev: 4)
    monkeypatch.setattr(fm.BwdScratch, "make", staticmethod(recording))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type("S", (), {"cuda_stream": 0}))
    packed = fm.pack_params(fm.cppn_params_to_list(weights[1]))
    fs.reset_counts()
    fs.fused_step_grads_cuda(packed, *arrays, step=step, early_stop_eps=EPS, n_rays_loss=r)
    rows = -(-r * k // TILE) * TILE
    assert lib.calls[0] == ("rows", r * k) and lib.calls[1][0] == "grads"
    (s,) = made
    assert s.acts.shape == s.dzs.shape == (N_HIDDEN + 1, rows, WIDTH)
    assert rows > r * k and fs.fused_step_launches == 1


def test_wrapper_refuses_2_31_samples(weights, monkeypatch):
    """The kernel forms sample indices in 32 bits: R k >= 2^31 raises
    before anything is allocated or launched."""
    lib = _FakeLib()
    monkeypatch.setattr(fs, "_lib", lib)
    r, k = 1 << 16, 1 << 15
    meta = dict(device="meta", dtype=torch.float32)
    o, d = torch.empty((r, 3), **meta), torch.empty((r, 3), **meta)
    t = torch.empty((r, k), **meta)
    packed = fm.pack_params(fm.cppn_params_to_list(weights[1]))
    with pytest.raises(ValueError, match="2\\^31"):
        fs.fused_step_grads_cuda(packed, o, d, t, t, torch.empty((r,), **meta), step=0.1,
                                 early_stop_eps=EPS, n_rays_loss=r)
    assert lib.calls == []
