"""Port: the premise of kernel #2's zero-gradient tile skip, on the CPU.

The backward kernel skips every 16-point tile whose upstream gradient g is
all zero (-0 counts as zero) and leaves such tiles out of the weight
gradients. That leaves every gradient as it was only if those points add
exact zeros: checked here on the plain version (against the same call on the
active points alone, and against the JAX Pallas kernel pair's VJP in
interpret mode), and on a CPU split step, whose composite must hand the MLP
exact zeros wherever the early-stop keep is 0. Inputs come from a numpy seed;
weights cross over with convert.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.models import CPPNConfig, init_cppn
from nerf_for_angiography_tpu.ops.pallas.fused_mlp import (
    cppn_params_to_list as jax_params_to_list,
)
from nerf_for_angiography_tpu.ops.pallas.fused_mlp import fused_mlp_raw as jax_fused_mlp_raw
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
from nerf_for_angiography_tpu_torch.models import CPPN
from nerf_for_angiography_tpu_torch.models import CPPNConfig as TorchCPPNConfig
from nerf_for_angiography_tpu_torch.ops import occupancy as ot
from nerf_for_angiography_tpu_torch.ops.kernels import build
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_for_angiography_tpu_torch.training import TrainConfig, create_train_state

tt = importlib.import_module("nerf_for_angiography_tpu_torch.training.train")

TILE = 16  # points per tile of the kernel's skip


def _setup(n_hidden, width, p, seed=0):
    """JAX params with non-zero biases, the port model carrying them, x."""
    _, params = init_cppn(
        CPPNConfig(num_early_layers=n_hidden, num_filters=width), jax.random.PRNGKey(seed)
    )
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    for leaf in params["params"].values():
        if isinstance(leaf, dict):
            leaf["bias"] = (0.1 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (p, 3)).astype(np.float32)
    model = CPPN(TorchCPPNConfig(num_early_layers=n_hidden, num_filters=width))
    model.load_state_dict(cppn_params_from_jax(params))
    return params, model, x


def zero_tiled_g(p, zero_share, seed=1):
    """(g (P,) f32 with g = 0 on a seeded ``zero_share`` of the 16-point
    tiles, standard normal elsewhere and with -0 on a few zero points; the
    bool mask of the points in zero tiles)."""
    rng = np.random.default_rng(seed)
    n_tiles = -(-p // TILE)
    zero_tiles = rng.permutation(n_tiles)[: int(round(zero_share * n_tiles))]
    zero = np.zeros(n_tiles, bool)
    zero[zero_tiles] = True
    zero = np.repeat(zero, TILE)[:p]
    g = rng.standard_normal(p).astype(np.float32)
    g[zero] = 0.0
    g[np.flatnonzero(zero)[::5]] = -0.0
    return g, zero


@pytest.mark.parametrize("n_hidden,width,p", [(2, 64, 1007), (4, 128, 517)])
def test_zero_tiles_add_exact_zeros(n_hidden, width, p):
    """The plain backward on a g zero on 70% of the tiles (P ragged) equals
    the same call on the active points alone, every gradient within 1e-5 of
    its max (only the f32 summation order differs), and dx is exactly 0 on
    the zero tiles."""
    _, model, x = _setup(n_hidden, width, p)
    g, zero = zero_tiled_g(p, 0.7)
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    grads, dx = fm.fused_mlp_bwd_reference(packed, torch.from_numpy(x), torch.from_numpy(g))
    keep = ~zero
    grads_a, dx_a = fm.fused_mlp_bwd_reference(
        packed, torch.from_numpy(x[keep]), torch.from_numpy(g[keep]))
    assert zero.sum() > 0.6 * p and keep.sum() > 0.2 * p
    for pair, pair_a in zip(grads, grads_a):
        for a, b in zip(pair, pair_a):
            scale = max(float(b.abs().max()), 1e-30)
            torch.testing.assert_close(a / scale, b / scale, atol=1e-5, rtol=0)
    assert bool((dx[torch.from_numpy(zero)] == 0).all())
    torch.testing.assert_close(dx[torch.from_numpy(keep)], dx_a, atol=0, rtol=0)


@pytest.mark.parametrize("n_hidden,width,p", [(2, 64, 1007), (4, 128, 517)])
def test_zero_tiled_g_matches_pallas_vjp(n_hidden, width, p):
    """The plain backward against the JAX fused_mlp_raw VJP (Pallas kernel
    pair in interpret mode) on the same zero-tiled g, with
    tests/test_torch_fused_mlp.py's limits; JAX's dx is 0 on the zero tiles
    too."""
    params, model, x = _setup(n_hidden, width, p)
    g, zero = zero_tiled_g(p, 0.7, seed=2)
    plist = jax_params_to_list(params, n_hidden)
    _, vjp = jax.vjp(lambda pl, xx: jax_fused_mlp_raw(pl, xx, True), plist, jnp.asarray(x))
    g_params, g_x = vjp(jnp.asarray(g))
    g_x = np.asarray(g_x)
    assert np.all(g_x[zero] == 0)

    packed = fm.pack_params(fm.cppn_params_to_list(model))
    grads, dx = fm.fused_mlp_bwd_reference(packed, torch.from_numpy(x), torch.from_numpy(g))
    for (dw, db), (dw_j, db_j) in zip(grads, g_params):
        for got, want in ((dw, dw_j), (db, db_j)):
            want = np.asarray(want).reshape(got.shape)
            scale = max(np.abs(want).max(), 1e-8)
            np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=3e-2)
    scale = max(np.abs(g_x).max(), 1e-8)
    np.testing.assert_allclose(dx.numpy() / scale, g_x / scale, atol=2e-2)


def _blob_grid(res=16):
    idx = np.stack(np.meshgrid(*[np.arange(res) + 0.5] * 3, indexing="ij"), -1)
    binary = ((idx - res / 2) ** 2).sum(-1) < (0.3 * res) ** 2
    return ot.grid_from_numpy(binary, [-100.0] * 3 + [100.0] * 3)


@pytest.mark.parametrize("compact_samples", [0, 12])
def test_split_step_hands_the_mlp_exact_zeros_where_keep_is_0(monkeypatch, compact_samples):
    """On a CPU split step (the dense lattice and a compacted lattice march),
    the gradient that reaches FusedMLPRaw.backward is exactly +-0 at every
    sample whose early-stop keep is 0, and not everywhere 0."""
    cfg = TrainConfig(
        compact_samples=compact_samples, march_mode="lattice", sample_size=8,
        depth_samples_per_ray=32, grid_resolution=16, num_layers=2, num_hidden_units=32,
        sampling_strategy="random", early_stop_eps=0.3, occ_stride=1,
    )
    model, _ = create_train_state(cfg, device="cpu")
    with torch.no_grad():  # dense enough that early stop cuts rays short
        model.linears()[-1].bias.fill_(3.0)
    rng = np.random.default_rng(3)
    o = np.zeros((64, 3), np.float32)
    o[:, :2] = rng.uniform(-20, 20, (64, 2))
    o[:, 2] = 1500.0
    target = rng.uniform(-110, 110, (64, 3)).astype(np.float32)
    target[:, 2] = 0.0
    d = (target - o) / 1500.0
    seen = []
    bwd = fm.fused_mlp_bwd

    def recording(packed, x, g, feature_major=False):
        seen.append(g.clone())
        return bwd(packed, x, g, feature_major)

    monkeypatch.setattr(fm, "fused_mlp_bwd", recording)
    pix, _, keep = tt.render_rays(model, _blob_grid(), torch.from_numpy(o), torch.from_numpy(d),
                                  cfg, 1400.0, 1600.0)
    ((pix - 0.5) ** 2).mean().backward()
    (g,) = seen
    keep = keep.reshape(-1)
    assert g.shape == keep.shape
    assert bool((keep == 0).any()) and bool((keep == 1).any())
    assert bool((g[keep == 0] == 0).all())
    assert bool((g[keep == 1] != 0).any())


def test_backward_wrapper_raises_without_a_build(monkeypatch):
    """No fallback: kernel #2's wrapper raises where it cannot be built."""
    _, model, x = _setup(2, 32, 40)
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    monkeypatch.setattr(fm, "_lib", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "Path", lambda p: type("P", (), {"exists": lambda self: False})())
    g, _ = zero_tiled_g(40, 0.5)
    with pytest.raises(RuntimeError, match="nvcc"):
        fm.fused_mlp_bwd_cuda(packed, torch.from_numpy(x), torch.from_numpy(g))


class _FakeLib:
    """The C interface of csrc/fused_mlp.cu, recording the backward's
    arguments; the on-chip backward runs at F = 128 (as oc_dims_ok says)."""

    def __init__(self):
        self.calls = []

    def fused_mlp_smem_bytes(self, f, nh):
        return 1024

    def fused_mlp_partial_stride(self, f, nh):
        return -(-(16 * f + nh * f * f + (nh + 1) * f + f + 1) // 64) * 64

    def fused_mlp_grad_size(self, f, nh):
        return 16 * f + nh * f * f + (nh + 1) * f + f + 1

    def fused_mlp_mask_slots(self, n_sms, nh):
        return n_sms * 8 * (nh + 1) * 32

    def fused_mlp_chunk_quantum(self):
        return 64

    def fused_mlp_scratch_rows(self, p):
        return -(-p // TILE) * TILE

    def fused_mlp_bwd_onchip(self, f, nh):
        return int(f == 128)

    def fused_mlp_bwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("width,onchip", [(128, True), (96, False)])
def test_backward_wrapper_allocates_scratch_only_for_the_two_kernel_path(
        monkeypatch, width, onchip):
    """The wrapper asks the library which backward a width takes: the
    on-chip one gets the partials alone (no acts, dz or mask slots) and is
    counted in ``bwd_onchip``; the two-kernel one gets its full scratch."""
    _, model, x = _setup(2, width, 1000)
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    lib = _FakeLib()
    made = []
    make = fm.BwdScratch.make

    def recording(*args, **kwargs):
        s = make(*args, **kwargs)
        made.append(s)
        return s

    monkeypatch.setattr(fm, "_lib", lib)
    monkeypatch.setattr(fm, "_num_sms", lambda dev: 4)
    monkeypatch.setattr(fm, "active_tiles", lambda dev: torch.zeros((1,), dtype=torch.int64))
    monkeypatch.setattr(fm.BwdScratch, "make", staticmethod(recording))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type("S", (), {"cuda_stream": 0}))
    g, _ = zero_tiled_g(1000, 0.5)
    fm.reset_counts()
    fm.fused_mlp_bwd_cuda(packed, torch.from_numpy(x), torch.from_numpy(g))
    (s,) = made
    (args,) = lib.calls
    assert (fm.bwd_launches, fm.bwd_onchip, fm.bwd_points) == (1, int(onchip), 1000)
    rows = 0 if onchip else 1008
    assert tuple(s.acts.shape) == tuple(s.dzs.shape) == (3, rows, width)
    assert s.masks.numel() == (0 if onchip else 4 * 8 * 3 * 32)
    assert s.n_chunks * s.chunk >= 1000 and s.chunk % 64 == 0
    assert s.partials.numel() == s.n_chunks * lib.fused_mlp_partial_stride(width, 2)
    assert args[12:18] == s.args()
