"""Port on the card: the CUDA kernels against their plain versions at small
and ragged shapes, the launch counters, one dense and one compacted train
step, the whole-step kernel's train steps, the feature-major layout and the
encoded (fourier / BARF) kernels and train steps, the SDF DRR against the CPU
and a resume checkpoint of CUDA tensors. Skipped without a GPU; on
the card run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(this file imports torch only)."""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig
from nerf_for_angiography_tpu_torch.ops.kernels import first_k as fk
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp_enc as fe

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed(n_hidden, width, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = CPPN(CPPNConfig(num_early_layers=n_hidden, num_filters=width), generator=gen)
    with torch.no_grad():
        for lin in model.linears():
            lin.bias.normal_(0.0, 0.1, generator=gen)
    return model.to(dev), fm.pack_params(fm.cppn_params_to_list(model.to(dev)))


@pytest.mark.parametrize("n_hidden,width,p", [
    (4, 128, 1), (4, 128, 63), (4, 128, 65), (4, 128, 3001), (2, 32, 1000),
    (0, 64, 777), (3, 16, 129), (2, 48, 500), (1, 128, 64 * 300 + 5),
])
def test_kernels_match_plain(dev, n_hidden, width, p):
    _, packed = _packed(n_hidden, width, dev)
    gen = torch.Generator().manual_seed(1)
    x = (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev)
    g = torch.randn((p,), generator=gen).to(dev)
    got = fm.fused_mlp_fwd_cuda(packed, x)
    want = fm.fused_mlp_fwd_reference(packed, x)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert float((got - want).abs().median()) < 1e-3
    grads_k, dx_k = fm.fused_mlp_bwd_cuda(packed, x, g)
    grads_p, dx_p = fm.fused_mlp_bwd_reference(packed, x, g)
    for (wk, bk), (wp, bp) in zip(grads_k, grads_p):
        for a, b in ((wk, wp), (bk, bp)):
            scale = max(float(b.abs().max()), 1e-12)
            torch.testing.assert_close(a / scale, b.reshape(a.shape) / scale, atol=3e-2, rtol=0)
    rel = float(torch.linalg.norm(dx_k - dx_p) / torch.linalg.norm(dx_p))
    assert rel < 3e-2
    # per point within 3e-2 of max |dx|, except where a relu pre-activation
    # sits so close to 0 that the two sum orders can flip its mask
    bad = ((dx_k - dx_p).abs() > 3e-2 * dx_p.abs().max()).any(dim=1)
    assert bool((_min_abs_preact(packed, x[bad]) < 1e-3).all())


def _min_abs_preact(packed, x):
    """Per point, the smallest |pre-activation| of the plain forward; x is
    the (P, 3) input or an encoded (P, KE) block."""
    h = x.to(torch.bfloat16).float()
    dist = torch.full((x.shape[0],), float("inf"), device=x.device)
    for w, b in zip([packed.w_in[:, : x.shape[1]]] + list(packed.w_hid), packed.bias):
        z = h @ w.float().T + b
        dist = torch.minimum(dist, z.abs().amin(dim=1))
        h = torch.relu(z).to(torch.bfloat16).float()
    return dist


def test_backward_is_deterministic(dev):
    _, packed = _packed(4, 128, dev)
    x = torch.rand((50_000, 3), device=dev) * 2 - 1
    g = torch.randn((50_000,), device=dev)
    a, dxa = fm.fused_mlp_bwd_cuda(packed, x, g)
    b, dxb = fm.fused_mlp_bwd_cuda(packed, x, g)
    assert all(torch.equal(u, v) for pa, pb in zip(a, b) for u, v in zip(pa, pb))
    assert torch.equal(dxa, dxb)


def _zero_tiled_g(p, zero_share, dev, seed=1):
    """g (P,) standard normal except on a seeded ``zero_share`` of the
    16-point tiles, where it is 0 (-0 on every fifth point), and the bool
    mask of the points in those tiles."""
    gen = torch.Generator().manual_seed(seed)
    n_tiles = -(-p // 16)
    zero = torch.zeros(n_tiles, dtype=torch.bool)
    zero[torch.randperm(n_tiles, generator=gen)[: int(round(zero_share * n_tiles))]] = True
    zero = zero.repeat_interleave(16)[:p]
    g = torch.randn((p,), generator=gen)
    g[zero] = 0.0
    g[zero.nonzero()[::5, 0]] = -0.0
    return g.to(dev), zero.to(dev)


@pytest.mark.parametrize("feature_major", [False, True])
@pytest.mark.parametrize("zero_share", [0.3, 0.7, 1.0])
def test_backward_skips_zero_gradient_tiles(dev, zero_share, feature_major):
    """Kernel #2 on a g zero on whole tiles (P ragged): within the plain
    version's limits, dx exactly 0 on the zero tiles, two launches
    bit-identical, and within 1e-5 of each gradient's max of the kernel on
    the active points alone (other chunks, so another f32 summation order)."""
    _, packed = _packed(4, 128, dev)
    p = 64 * 300 + 5
    gen = torch.Generator().manual_seed(2)
    x = (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev)
    g, zero = _zero_tiled_g(p, zero_share, dev)
    xin = x.T.contiguous() if feature_major else x
    grads_k, dx_k = fm.fused_mlp_bwd_cuda(packed, xin, g, feature_major)
    grads_k2, dx_k2 = fm.fused_mlp_bwd_cuda(packed, xin, g, feature_major)
    grads_p, dx_p = fm.fused_mlp_bwd_reference(packed, xin, g, feature_major)
    torch.cuda.synchronize()
    if feature_major:
        dx_k, dx_k2, dx_p = dx_k.T, dx_k2.T, dx_p.T
    assert all(torch.equal(u, v) for a, b in zip(grads_k, grads_k2) for u, v in zip(a, b))
    assert torch.equal(dx_k, dx_k2)
    assert bool((dx_k[zero] == 0).all())
    for (wk, bk), (wp, bp) in zip(grads_k, grads_p):
        for a, b in ((wk, wp), (bk, bp)):
            scale = max(float(b.abs().max()), 1e-12)
            torch.testing.assert_close(a / scale, b.reshape(a.shape) / scale, atol=3e-2, rtol=0)
    if zero_share == 1.0:
        assert all(bool((t == 0).all()) for pair in grads_k for t in pair)
        assert bool((dx_k == 0).all())
        return
    rel = float(torch.linalg.norm(dx_k - dx_p) / torch.linalg.norm(dx_p))
    assert rel < 3e-2
    bad = ((dx_k - dx_p).abs() > 3e-2 * dx_p.abs().max()).any(dim=1)
    assert bool((_min_abs_preact(packed, x[bad]) < 1e-3).all())
    act = ~zero
    grads_a, dx_a = fm.fused_mlp_bwd_cuda(packed, x[act].contiguous(), g[act].contiguous())
    for (wk, bk), (wa, ba) in zip(grads_k, grads_a):
        for a, b in ((wk, wa), (bk, ba)):
            scale = max(float(b.abs().max()), 1e-30)
            torch.testing.assert_close(a / scale, b / scale, atol=1e-5, rtol=0)
    assert torch.equal(dx_k[act], dx_a)


def test_autograd_launches_the_kernels(dev):
    model, _ = _packed(2, 64, dev)
    fm.reset_counts()
    x = (torch.rand((4000, 3), device=dev) * 2 - 1).requires_grad_(True)
    raw = fm.fused_mlp_raw(fm.cppn_params_to_list(model), x)
    raw.square().mean().backward()
    torch.cuda.synchronize()
    assert fm.fwd_launches == 1 and fm.bwd_launches == 1
    assert x.grad is not None and model.early_0.weight.grad is not None


def test_unsupported_width_raises(dev):
    _, packed = _packed(1, 40, dev)  # the kernels need F % 16 == 0
    with pytest.raises(ValueError):
        fm.fused_mlp_fwd_cuda(packed, torch.zeros((10, 3), device=dev))


def test_weights_beyond_shared_memory_raise(dev):
    # every weight stays in shared memory: 7 hidden 128-wide layers do not fit
    _, packed = _packed(7, 128, dev)
    with pytest.raises(ValueError, match="shared memory"):
        fm.fused_mlp_fwd_cuda(packed, torch.zeros((10, 3), device=dev))


def test_train_step_on_card(dev):
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_sphere_volume,
    )
    from nerf_for_angiography_tpu_torch.training import (
        TrainConfig, create_train_state, make_train_step,
    )

    ds = generate_dataset(
        make_sphere_volume(res=32), DatagenConfig(limited_size=90.0, number_angles=1.0,
                                                  img_width=16, img_height=16,
                                                  sample_outside=100.0), device=dev,
    )
    cfg = TrainConfig(compact_samples=0, sample_size=16, depth_samples_per_ray=64,
                      grid_resolution=32)
    model, state = create_train_state(cfg, device=dev)
    step = make_train_step(model, cfg, 1400.0, 1600.0)
    fm.reset_counts()
    state, metrics, _, _ = step(state, ds.rays)
    assert torch.isfinite(metrics["loss/train-pixel-coarse"])
    assert fm.fwd_launches == 2 and fm.bwd_launches == 1  # grid update + step


@pytest.mark.parametrize("rows,w,k,p", [
    (1, 1, 1, 0.5), (5625, 300, 96, 0.3), (5625, 300, 192, 0.9), (4218, 48, 56, 0.6),
    (1407, 160, 96, 0.5), (100, 33, 200, 0.9), (77, 1030, 64, 0.05), (64, 64, 64, 1.0),
    (64, 64, 8, 0.0), (9, 31, 40, 1.0),
])
def test_first_k_kernel_matches_plain(dev, rows, w, k, p):
    gen = torch.Generator().manual_seed(rows + w + k)
    mask = (torch.rand((rows, w), generator=gen) < p).to(torch.float32).to(dev)
    fk.reset_counts()
    sel, mask_k = fk.first_k_active_cuda(mask, k)
    want_sel, want_mask_k = fk.first_k_active_reference(mask, k)
    torch.cuda.synchronize()
    assert sel.dtype == torch.int32 and mask_k.dtype == torch.float32
    assert torch.equal(sel, want_sel) and torch.equal(mask_k, want_mask_k)
    assert fk.launches == 1 and fk.shapes == {(rows, w, k)}


def test_first_k_batch_shape_and_rules(dev):
    mask = (torch.rand((3, 5, 40), device=dev) < 0.5).to(torch.float32)
    sel, mask_k = fk.first_k_active(mask, 16)
    want_sel, want_mask_k = fk.first_k_active_reference(mask, 16)
    assert sel.shape == (3, 5, 16) and torch.equal(sel, want_sel)
    assert torch.equal(mask_k, want_mask_k)
    with pytest.raises(ValueError):
        fk.first_k_active(mask.to(torch.float16), 16)
    with pytest.raises(ValueError):
        fk.first_k_active(mask.clone().requires_grad_(True), 16)


def test_compacted_step_on_card_launches_the_kernel(dev, monkeypatch):
    """A hybrid2k step on the card reaches the first-k kernel twice (one
    launch per bucket) and never the plain version."""
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_sphere_volume,
    )
    from nerf_for_angiography_tpu_torch.ops.occupancy import BucketedRays
    from nerf_for_angiography_tpu_torch.training import (
        TrainConfig, create_train_state, make_train_step,
    )
    from nerf_for_angiography_tpu_torch.training.train import _march_for

    def plain_refused(*args, **kwargs):
        raise AssertionError("the plain first-k version ran on the card")

    monkeypatch.setattr(fk, "first_k_active_reference", plain_refused)
    ds = generate_dataset(
        make_sphere_volume(res=32), DatagenConfig(limited_size=90.0, number_angles=1.0,
                                                  img_width=16, img_height=16,
                                                  sample_outside=100.0), device=dev,
    )
    cfg = TrainConfig(sample_size=16, depth_samples_per_ray=64, grid_resolution=32,
                      march_mode="hybrid", compact_samples=24, hybrid_w_cap=48,
                      hybrid_w_lo=24, hybrid_k_lo=12)
    model, state = create_train_state(cfg, device=dev)
    assert isinstance(_march_for(cfg, state.grid, ds.rays.origins[:256],
                                 ds.rays.directions[:256], 1400.0, 1600.0), BucketedRays)
    step = make_train_step(model, cfg, 1400.0, 1600.0)
    fk.reset_counts()
    state, metrics, _, _ = step(state, ds.rays)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss/train-pixel-coarse"])
    assert fk.launches == 2 and int(metrics["march/ac"]) >= 0


def _march_inputs(r, k, dev, eps_scale=1.0, masked_rows=5, p_active=0.7, seed=0):
    """Rays, depth-ascending midpoints at one lattice step, a mask with
    ``masked_rows`` all-zero rows first, and targets (numpy seed)."""
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((r, 3)) * 0.3).astype(np.float32)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = rng.integers(0, 5, (r, 1)).astype(np.float32)
    t_mid = (2.0 + (start + np.arange(k, dtype=np.float32) + 0.5) * eps_scale).astype(np.float32)
    mask = (rng.uniform(size=(r, k)) < p_active).astype(np.float32)
    mask[:masked_rows] = 0.0
    tgt = rng.uniform(size=r).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (o, d, t_mid, mask, tgt)]


def _eps_tie_dist(packed, o, d, t_mid, mask, kw):
    """Per ray, the smallest |T / eps - 1| over its active samples of the
    plain forward's exclusive transmittance T: a keep that flips between two
    sigma roundings sits at such a tie."""
    r, k = t_mid.shape
    s, step = kw["input_scale"], kw["step"]
    x = ((o * s)[:, None, :] + (d * s)[:, None, :] * t_mid[..., None]).reshape(-1, 3)
    _, acts = fm._forward_acts(packed, x)
    tau = torch.sigmoid(fm._head(packed, acts)).reshape(r, k) * step * mask
    t_excl = torch.exp(-(torch.cumsum(tau, dim=1) - tau))
    dist = (t_excl / kw["early_stop_eps"] - 1).abs()
    return torch.where(mask > 0, dist, torch.full_like(dist, float("inf"))).amin(dim=1)


def _assert_fused_step_close(got, want, packed, inputs, kw):
    """chip_smoke.py's limits (the kernel and its plain version share their
    cast points): pixels max abs 5e-4 except at early-stop ties (a ray beyond
    it must have a transmittance within 1e-3 of eps, relative, at one of its
    active samples; at most max(1, R / 1000) such rays), median 1e-5, every
    gradient within 1e-3 of the plain version's max."""
    (px_k, g_k), (px_p, g_p) = got, want
    err = (px_k - px_p).abs()
    bad = err > 5e-4
    if bool(bad.any()):
        assert int(bad.sum()) <= max(1, px_k.shape[0] // 1000)
        assert kw["early_stop_eps"] > 0
        tie = _eps_tie_dist(packed, *(t[bad] for t in inputs[:4]), kw)
        assert bool((tie < 1e-3).all()), tie
    assert float(err.median()) <= 1e-5
    for (wk, bk), (wp, bp) in zip(g_k, g_p):
        for a, b in ((wk, wp), (bk, bp)):
            assert bool(torch.isfinite(a).all())
            scale = max(float(b.abs().max()), 1e-12)
            torch.testing.assert_close(a / scale, b.reshape(a.shape) / scale, atol=1e-3, rtol=0)


@pytest.mark.parametrize("n_hidden,width,r,k,eps", [
    (2, 32, 700, 7, 0.05), (4, 128, 1000, 96, 1e-2), (4, 128, 517, 1, 0.0),
    (3, 64, 33, 40, 0.5), (4, 128, 1407, 160, 1e-2), (1, 64, 5, 300, 1e-2),
])
def test_fused_step_kernel_matches_plain(dev, n_hidden, width, r, k, eps):
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs

    _, packed = _packed(n_hidden, width, dev)
    o, d, t_mid, mask, tgt = _march_inputs(r, k, dev, eps_scale=1.5 if k < 50 else 0.2)
    kw = dict(step=1.5 if k < 50 else 0.2, early_stop_eps=eps, n_rays_loss=r, input_scale=0.9)
    fs.reset_counts()
    got = fs.fused_step_grads_cuda(packed, o, d, t_mid, mask, tgt, **kw)
    want = fs.fused_step_grads_reference(packed, o, d, t_mid, mask, tgt, **kw)
    torch.cuda.synchronize()
    assert fs.fused_step_launches == 1 and fs.shapes == {(r, k)}
    _assert_fused_step_close(got, want, packed, (o, d, t_mid, mask), kw)
    # the all-masked rays render 1 exactly
    assert bool((got[0][:5] == 1.0).all())


def test_fused_step_all_masked_gives_zero_grads_and_is_deterministic(dev):
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs

    _, packed = _packed(4, 128, dev)
    o, d, t_mid, mask, tgt = _march_inputs(3001, 64, dev, eps_scale=0.5)
    kw = dict(step=0.5, early_stop_eps=1e-2, n_rays_loss=3001)
    px, grads = fs.fused_step_grads_cuda(packed, o, d, t_mid, torch.zeros_like(mask),
                                         torch.ones_like(tgt), **kw)
    assert bool((px == 1.0).all())
    assert all(float(t.abs().max()) == 0.0 for pair in grads for t in pair)
    a = fs.fused_step_grads_cuda(packed, o, d, t_mid, mask, tgt, **kw)
    b = fs.fused_step_grads_cuda(packed, o, d, t_mid, mask, tgt, **kw)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(u, v) for pa, pb in zip(a[1], b[1]) for u, v in zip(pa, pb))


@pytest.mark.parametrize("p", [1, 1000, 50_000 + 3])
def test_feature_major_launch_equals_point_major(dev, p):
    _, packed = _packed(4, 128, dev)
    x = torch.rand((p, 3), device=dev) * 2 - 1
    g = torch.randn((p,), device=dev)
    x_fm = x.T.contiguous()
    fm.reset_counts()
    assert torch.equal(fm.fused_mlp_fwd_cuda(packed, x_fm, True), fm.fused_mlp_fwd_cuda(packed, x))
    grads_fm, dx_fm = fm.fused_mlp_bwd_cuda(packed, x_fm, g, True)
    grads_pm, dx_pm = fm.fused_mlp_bwd_cuda(packed, x, g)
    assert dx_fm.shape == (3, p) and torch.equal(dx_fm, dx_pm.T)
    assert all(torch.equal(u, v) for pa, pb in zip(grads_fm, grads_pm) for u, v in zip(pa, pb))
    assert fm.fwd_launches == 2 and fm.bwd_launches == 2
    with pytest.raises(ValueError, match=r"\(3, P\)"):
        fm.fused_mlp_fwd_cuda(packed, x, True)


@pytest.mark.parametrize("cfg_kw,steps_per_call", [
    (dict(compact_samples=0), 1),
    (dict(march_mode="hybrid", compact_samples=24, hybrid_w_cap=48, hybrid_w_lo=24,
          hybrid_k_lo=12), 2),
])
def test_fused_train_step_on_card_launches_the_kernel(dev, monkeypatch, cfg_kw, steps_per_call):
    """fused_train_step 'auto' on the card: one fused-step launch per
    rectangular march (two on a two-bucket march), no split backward, and
    never the plain version."""
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_sphere_volume,
    )
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs
    from nerf_for_angiography_tpu_torch.training import (
        TrainConfig, create_train_state, make_train_step,
    )

    def plain_refused(*args, **kwargs):
        raise AssertionError("the plain fused-step version ran on the card")

    monkeypatch.setattr(fs, "fused_step_grads_reference", plain_refused)
    ds = generate_dataset(
        make_sphere_volume(res=32), DatagenConfig(limited_size=90.0, number_angles=1.0,
                                                  img_width=16, img_height=16,
                                                  sample_outside=100.0), device=dev,
    )
    cfg = TrainConfig(sample_size=16, depth_samples_per_ray=64, grid_resolution=32,
                      fused_train_step="auto", **cfg_kw)
    model, state = create_train_state(cfg, device=dev)
    step = make_train_step(model, cfg, 1400.0, 1600.0)
    fm.reset_counts()
    fs.reset_counts()
    for _ in range(2):
        state, metrics, _, _ = step(state, ds.rays)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss/train-pixel-coarse"])
    assert fs.fused_step_launches == 2 * steps_per_call and fm.bwd_launches == 0


def _skip_march(r, k, step, dev, seed=0):
    """A march that exercises kernel #6's skips (tests/test_torch_fused_step_skip.py's):
    midpoints one ``step`` apart, a 70% mask with a third of the flat
    16-sample tiles and ray 0 all zero, targets; numpy seed."""
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((r, 3)) * 0.3).astype(np.float32)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = rng.integers(0, 5, (r, 1)).astype(np.float32)
    t_mid = (2.0 + (start + np.arange(k, dtype=np.float32) + 0.5) * step).astype(np.float32)
    mask = (rng.uniform(size=(r, k)) < 0.7).astype(np.float32)
    flat = mask.reshape(-1)
    n_tiles = -(-flat.size // 16)
    for tile in rng.permutation(n_tiles)[: n_tiles // 3]:
        flat[tile * 16:(tile + 1) * 16] = 0.0
    mask[0] = 0.0
    tgt = rng.uniform(size=r).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (o, d, t_mid, mask, tgt)]


# (R, k, step): R k ragged (% 16 = 8, 12, 10), tiles across ray boundaries
_SKIP_MARCHES = [(37, 56, 0.4), (29, 300, 0.06), (1409, 90, 0.1)]


@pytest.mark.parametrize("n_hidden,width", [(2, 32), (4, 128)])
@pytest.mark.parametrize("r,k,step", _SKIP_MARCHES)
def test_fused_step_skips_match_plain(dev, n_hidden, width, r, k, step):
    """Kernel #6 on marches with whole masked tiles, rays cut short by the
    early stop (output bias 2: sigma ~ 0.9) and an all-zero ray: within the
    step limits against its plain version, two launches bit-identical, the
    all-zero ray at 1 exactly, and more tiles active by the mask than by the
    draw (the backward skips the rest)."""
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs

    model, _ = _packed(n_hidden, width, dev)
    with torch.no_grad():
        model.linears()[-1].bias.fill_(2.0)
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    o, d, t_mid, mask, tgt = _skip_march(r, k, step, dev)
    kw = dict(step=step, early_stop_eps=1e-2, n_rays_loss=r, input_scale=1.0)
    fs.reset_counts()
    got = fs.fused_step_grads_cuda(packed, o, d, t_mid, mask, tgt, **kw)
    again = fs.fused_step_grads_cuda(packed, o, d, t_mid, mask, tgt, **kw)
    want = fs.fused_step_grads_reference(packed, o, d, t_mid, mask, tgt, **kw)
    _, draw, _, _ = fs.draws_reference(packed, o, d, t_mid, mask, tgt, **kw)
    torch.cuda.synchronize()
    assert fs.fused_step_launches == 2
    _assert_fused_step_close(got, want, packed, (o, d, t_mid, mask), kw)
    assert torch.equal(got[0], again[0])
    assert all(torch.equal(u, v) for a, b in zip(got[1], again[1]) for u, v in zip(a, b))
    assert float(got[0][0]) == 1.0

    def tiles(flags):
        flat = torch.nn.functional.pad(flags.reshape(-1), (0, (-r * k) % 16))
        return flat.reshape(-1, 16).any(dim=1)

    by_mask, by_draw = tiles(mask != 0), tiles(draw != 0)
    assert not bool((by_draw & ~by_mask).any())
    assert int((by_mask & ~by_draw).sum()) > 0


@pytest.mark.parametrize("r,k", [(37, 56), (29, 300), (1, 1)])
def test_fused_step_all_masked_ragged(dev, r, k):
    """An all-zero mask at a ragged R k: no tile is listed, every pixel is 1
    and every gradient 0."""
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs

    _, packed = _packed(4, 128, dev)
    o, d, t_mid, mask, _ = _skip_march(r, k, 0.1, dev)
    px, grads = fs.fused_step_grads_cuda(packed, o, d, t_mid, torch.zeros_like(mask),
                                         torch.rand((r,), device=dev), step=0.1,
                                         early_stop_eps=1e-2, n_rays_loss=r)
    torch.cuda.synchronize()
    assert bool((px == 1.0).all())
    assert all(float(t.abs().max()) == 0.0 for pair in grads for t in pair)


@pytest.mark.parametrize("r,k,eps", [
    (5625, 160, 1e-2), (4218, 56, 1e-2), (1407, 96, 0.5), (33, 300, 1e-2), (5, 1, 0.0),
    (100, 65, 0.2),
])
def test_fused_step_scan_matches_one_thread_a_ray(dev, r, k, eps):
    """Kernel #6's composite scan (rows staged in shared memory, 32 rays a
    block) gives the pixels and draws of the one-thread-a-ray scan over
    device memory bit for bit, with masked-out samples holding NaN sigma
    (never read) and rays that stop early."""
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs

    gen = torch.Generator().manual_seed(r + k)
    sigma = torch.rand((r, k), generator=gen)
    mask = (torch.rand((r, k), generator=gen) < 0.6).float()
    sigma[mask == 0] = float("nan")
    tgt = torch.rand((r,), generator=gen)
    args = [t.to(dev) for t in (sigma, mask, tgt)]
    kw = dict(step=0.3, early_stop_eps=eps, n_rays_loss=r)
    px, draw = fs.fused_step_scan_cuda(*args, **kw)
    px_s, draw_s = fs.fused_step_scan_cuda(*args, serial=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(px, px_s) and torch.equal(draw, draw_s)
    assert bool(torch.isfinite(draw).all()) and bool((draw[mask.to(dev) == 0] == 0).all())


def test_fused_step_failure_raises(dev, monkeypatch):
    """No fallback for kernel #6: a launch that fails and a build that
    cannot run both raise, and the plain version never runs on the card."""
    from nerf_for_angiography_tpu_torch.ops.kernels import build
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs

    def plain_refused(*args, **kwargs):
        raise AssertionError("the plain whole-step version ran on the card")

    monkeypatch.setattr(fs, "fused_step_grads_reference", plain_refused)
    monkeypatch.setattr(fs, "draws_reference", plain_refused)
    model, _ = _packed(2, 64, dev)
    plist = fm.cppn_params_to_list(model)
    o, d, t_mid, mask, tgt = _skip_march(37, 56, 0.4, dev)
    kw = dict(step=0.4, early_stop_eps=1e-2, n_rays_loss=37)
    lib = fs._load_lib()

    class FailingLaunch:
        def __getattr__(self, name):
            return getattr(lib, name)

        def fused_step_grads(self, *args):
            return 1  # cudaErrorInvalidValue

    fs.reset_counts()
    monkeypatch.setattr(fs, "_lib", FailingLaunch())
    with pytest.raises(RuntimeError, match="launch failed"):
        fs.fused_step_grads(plist, o, d, t_mid, mask, tgt, **kw)
    monkeypatch.setattr(fs, "_lib", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "Path", lambda p: type("P", (), {"exists": lambda self: False})())
    monkeypatch.setattr(build, "source_tag", lambda source: "not-built")
    with pytest.raises(RuntimeError, match="nvcc"):
        fs.fused_step_grads(plist, o, d, t_mid, mask, tgt, **kw)
    assert fs.fused_step_launches == 0


# ---------------------------------------------------------------------------
# kernel #1: the warpgroup-MMA forward at every width it takes
# ---------------------------------------------------------------------------

# ragged P (P % 64 in {1, 17, 63}) and P below one 64-point tile
_WGMMA_PS = (64 * 37 + 1, 64 * 5 + 17, 64 * 41 + 63, 50)


@pytest.mark.parametrize("n_hidden", [0, 1, 4])
@pytest.mark.parametrize("width", [16, 32, 48, 64, 80, 96, 112, 128])
def test_wgmma_forward_matches_plain(dev, width, n_hidden):
    """The forward kernel against its plain version within the forward
    limits (max abs <= 2e-2 s, median <= 1e-3 s, s = max(1, max |raw|)), two
    launches bit-identical and the (3, P) launch equal to the (P, 3) one."""
    _, packed = _packed(n_hidden, width, dev, seed=width + n_hidden)
    gen = torch.Generator().manual_seed(3)
    for p in _WGMMA_PS:
        x = (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev)
        got = fm.fused_mlp_fwd_cuda(packed, x)
        again = fm.fused_mlp_fwd_cuda(packed, x)
        fmaj = fm.fused_mlp_fwd_cuda(packed, x.T.contiguous(), True)
        want = fm.fused_mlp_fwd_reference(packed, x)
        torch.cuda.synchronize()
        s = max(1.0, float(want.abs().max()))
        err = (got - want).abs()
        assert got.shape == (p,) and bool(torch.isfinite(got).all())
        assert float(err.max()) <= 2e-2 * s and float(err.median()) <= 1e-3 * s, p
        assert torch.equal(got, again) and torch.equal(got, fmaj), p


def test_wgmma_forward_at_the_shared_memory_limit(dev):
    # the most hidden 128-wide layers the kernels take (7 do not fit)
    _, packed = _packed(6, 128, dev)
    x = torch.rand((64 * 300 + 5, 3), device=dev) * 2 - 1
    got = fm.fused_mlp_fwd_cuda(packed, x)
    want = fm.fused_mlp_fwd_reference(packed, x)
    s = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 2e-2 * s
    assert float((got - want).abs().median()) <= 1e-3 * s


def test_cuda_tensors_never_reach_the_plain_version(dev, monkeypatch):
    """On the card the autograd function and the dispatchers launch the
    kernels; the plain versions are never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("fused_mlp_fwd_reference", "fused_mlp_bwd_reference", "_forward_acts",
                 "backward_from_acts"):
        monkeypatch.setattr(fm, name, refuse)
    model, _ = _packed(4, 128, dev)
    fm.reset_counts()
    x = (torch.rand((5000, 3), device=dev) * 2 - 1).requires_grad_(True)
    fm.fused_mlp_raw(fm.cppn_params_to_list(model), x).sum().backward()
    x_fm = (torch.rand((3, 777), device=dev) * 2 - 1).requires_grad_(True)
    fm.fused_mlp_raw_fm(fm.cppn_params_to_list(model), x_fm).sum().backward()
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    fm.fused_mlp_fwd(packed, x.detach())
    torch.cuda.synchronize()
    assert fm.fwd_launches == 3 and fm.bwd_launches == 2
    assert x.grad is not None and x_fm.grad is not None


def test_sampling_table_repeats_bit_for_bit(dev):
    from nerf_for_angiography_tpu_torch.ops.sampling import build_sampling_table

    w = torch.rand((260_000,), device=dev) + 1e-3
    first = build_sampling_table(w)
    assert first.device.type == "cuda"
    assert all(torch.equal(first, build_sampling_table(w)) for _ in range(5))


# ---------------------------------------------------------------------------
# the encoded (fourier / BARF) kernels
# ---------------------------------------------------------------------------


def _enc_model(n_hidden, width, kind, n_basis, dev, alpha=2.7, seed=0):
    """A port CPPN with non-zero biases (fourier coefficients ~ N(0, 5^2)),
    its kernel-layout weights and (a, w)."""
    from nerf_for_angiography_tpu_torch.models import barf_k_values, barf_weights

    gen = torch.Generator().manual_seed(seed)
    model = CPPN(CPPNConfig(num_early_layers=n_hidden, num_filters=width, pos_enc=kind,
                            pos_enc_basis=n_basis), generator=gen)
    with torch.no_grad():
        for lin in model.linears():
            lin.bias.normal_(0.0, 0.1, generator=gen)
    model = model.to(dev)
    packed = fe.pack_enc_params(fm.cppn_params_to_list(model), n_basis)
    if kind == "fourier":
        enc = model.fourier_coefficients_pts.detach()
    else:
        enc = barf_weights(alpha, barf_k_values(n_basis, 3)).to(dev)
    a, w = fe.enc_arrays(kind, n_basis, enc)
    return model, packed, a.contiguous(), w.contiguous()


@pytest.mark.parametrize("n_hidden,width,kind,n_basis,p", [
    (4, 128, "fourier", 5, 1), (4, 128, "fourier", 5, 3001), (4, 128, "barf", 5, 3001),
    (4, 128, "barf", 2, 777), (2, 64, "fourier", 5, 65), (2, 64, "fourier", 2, 1000),
    (1, 128, "barf", 10, 64 * 300 + 5), (3, 48, "fourier", 3, 129), (2, 32, "barf", 4, 500),
])
def test_enc_kernels_match_plain(dev, n_hidden, width, kind, n_basis, p):
    _, packed, a, w = _enc_model(n_hidden, width, kind, n_basis, dev)
    gen = torch.Generator().manual_seed(1)
    x = (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev)
    g = torch.randn((p,), generator=gen).to(dev)
    got = fe.fused_mlp_enc_fwd_cuda(packed, a, w, x)
    want = fe.fused_mlp_enc_fwd_reference(packed, a, w, x)
    s = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=2e-2 * s, rtol=0)
    assert float((got - want).abs().median()) < 1e-3 * s
    grads_k, da_k, dx_k = fe.fused_mlp_enc_bwd_cuda(packed, a, w, x, g)
    grads_p, da_p, dx_p = fe.fused_mlp_enc_bwd_reference(packed, a, w, x, g)
    for (wk, bk), (wp, bp) in zip(grads_k, grads_p):
        for u, v in ((wk, wp), (bk, bp)):
            scale = max(float(v.abs().max()), 1e-12)
            torch.testing.assert_close(u / scale, v.reshape(u.shape) / scale, atol=3e-2, rtol=0)
    # dA (dcoeff's two terms per band), held like a gradient
    scale = max(float(da_p.abs().max()), 1e-12)
    torch.testing.assert_close(da_k / scale, da_p / scale, atol=3e-2, rtol=0)
    rel = float(torch.linalg.norm(dx_k - dx_p) / torch.linalg.norm(dx_p))
    assert rel < 3e-2
    # per point within 3e-2 of max |dx|, except at relu ties
    bad = ((dx_k - dx_p).abs() > 3e-2 * dx_p.abs().max()).any(dim=1)
    enc, _ = fe.encode(x[bad], a, w, packed.w_in.shape[1])
    assert bool((_min_abs_preact(packed, enc) < 1e-3).all())


@pytest.mark.parametrize("kind", ["fourier", "barf"])
def test_enc_backward_is_deterministic(dev, kind):
    _, packed, a, w = _enc_model(4, 128, kind, 5, dev)
    x = torch.rand((50_000, 3), device=dev) * 2 - 1
    g = torch.randn((50_000,), device=dev)
    ga, daa, dxa = fe.fused_mlp_enc_bwd_cuda(packed, a, w, x, g)
    gb, dab, dxb = fe.fused_mlp_enc_bwd_cuda(packed, a, w, x, g)
    assert all(torch.equal(u, v) for pa, pb in zip(ga, gb) for u, v in zip(pa, pb))
    assert torch.equal(daa, dab) and torch.equal(dxa, dxb)
    assert torch.equal(fe.fused_mlp_enc_fwd_cuda(packed, a, w, x),
                       fe.fused_mlp_enc_fwd_cuda(packed, a, w, x))


# (n_basis, KE): every encoded input width the kernels take
_ENC_WIDTHS = [(2, 16), (4, 32), (5, 48), (10, 64)]


@pytest.mark.parametrize("zero_share", [0.3, 0.7])
@pytest.mark.parametrize("n_basis,ke", _ENC_WIDTHS)
def test_enc_backward_skips_zero_gradient_tiles(dev, n_basis, ke, zero_share):
    """Kernel #4 on a g zero on whole tiles (-0 on some points; P ragged):
    within the plain version's limits (as kernel #2's test), dx exactly 0 on
    the zero tiles, two launches bit-identical, and within 1e-5 of each
    gradient's and dA's max of the kernel on the active points alone
    (other chunks, so another f32 summation order), dx there equal."""
    _, packed, a, w = _enc_model(4, 128, "fourier", n_basis, dev)
    assert packed.w_in.shape[1] == ke
    p = 64 * 300 + 5
    gen = torch.Generator().manual_seed(2)
    x = (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev)
    g, zero = _zero_tiled_g(p, zero_share, dev)
    grads_k, da_k, dx_k = fe.fused_mlp_enc_bwd_cuda(packed, a, w, x, g)
    grads_k2, da_k2, dx_k2 = fe.fused_mlp_enc_bwd_cuda(packed, a, w, x, g)
    grads_p, da_p, dx_p = fe.fused_mlp_enc_bwd_reference(packed, a, w, x, g)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for a_, b_ in zip(grads_k, grads_k2) for u, v in zip(a_, b_))
    assert torch.equal(da_k, da_k2) and torch.equal(dx_k, dx_k2)
    assert bool((dx_k[zero] == 0).all())
    for u, v in [*((u, v) for pk, pp in zip(grads_k, grads_p) for u, v in zip(pk, pp)),
                 (da_k, da_p)]:
        scale = max(float(v.abs().max()), 1e-12)
        torch.testing.assert_close(u / scale, v.reshape(u.shape) / scale, atol=3e-2, rtol=0)
    rel = float(torch.linalg.norm(dx_k - dx_p) / torch.linalg.norm(dx_p))
    assert rel < 3e-2
    bad = ((dx_k - dx_p).abs() > 3e-2 * dx_p.abs().max()).any(dim=1)
    enc, _ = fe.encode(x[bad], a, w, ke)
    assert bool((_min_abs_preact(packed, enc) < 1e-3).all())
    act = ~zero
    grads_a, da_a, dx_a = fe.fused_mlp_enc_bwd_cuda(packed, a, w, x[act].contiguous(),
                                                    g[act].contiguous())
    for u, v in [*((u, v) for pk, pa in zip(grads_k, grads_a) for u, v in zip(pk, pa)),
                 (da_k, da_a)]:
        scale = max(float(v.abs().max()), 1e-30)
        torch.testing.assert_close(u / scale, v / scale, atol=1e-5, rtol=0)
    assert torch.equal(dx_k[act], dx_a)


@pytest.mark.parametrize("kind", ["fourier", "barf"])
def test_enc_backward_all_zero_g_gives_zero_outputs(dev, kind):
    """Every tile skipped: kernel #4's gradients, dA and dx are all 0."""
    _, packed, a, w = _enc_model(4, 128, kind, 5, dev)
    p = 64 * 41 + 63
    x = torch.rand((p, 3), device=dev) * 2 - 1
    g = torch.zeros((p,), device=dev)
    g[::3] = -0.0
    grads, da, dx = fe.fused_mlp_enc_bwd_cuda(packed, a, w, x, g)
    torch.cuda.synchronize()
    assert all(bool((t == 0).all()) for pair in grads for t in pair)
    assert bool((da == 0).all()) and bool((dx == 0).all())


def test_enc_backward_failure_raises(dev, monkeypatch):
    """No fallback for kernel #4: a launch that fails and a build that
    cannot run both raise, and the plain version never runs on the card."""
    from nerf_for_angiography_tpu_torch.ops.kernels import build

    def plain_refused(*args, **kwargs):
        raise AssertionError("the plain encoded backward ran on the card")

    monkeypatch.setattr(fe, "fused_mlp_enc_bwd_reference", plain_refused)
    _, packed, a, w = _enc_model(2, 64, "fourier", 5, dev)
    x = torch.rand((1000, 3), device=dev) * 2 - 1
    g, _ = _zero_tiled_g(1000, 0.5, dev)
    lib = fe._load_lib()

    class FailingLaunch:
        def __getattr__(self, name):
            return getattr(lib, name)

        def fused_mlp_enc_bwd(self, *args):
            return 1  # cudaErrorInvalidValue

    fe.reset_counts()
    monkeypatch.setattr(fe, "_lib", FailingLaunch())
    with pytest.raises(RuntimeError, match="launch failed"):
        fe.fused_mlp_enc_bwd(packed, a, w, x, g)
    monkeypatch.setattr(fe, "_lib", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "Path", lambda p: type("P", (), {"exists": lambda self: False})())
    monkeypatch.setattr(build, "source_tag", lambda source: "not-built")
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.fused_mlp_enc_bwd(packed, a, w, x, g)
    assert fe.enc_bwd_launches == 0


def test_enc_autograd_launches_the_kernels(dev):
    model, _, _, _ = _enc_model(2, 64, "fourier", 5, dev)
    fe.reset_counts()
    fm.reset_counts()
    x = (torch.rand((4000, 3), device=dev) * 2 - 1).requires_grad_(True)
    raw = fe.fused_mlp_enc_raw(("fourier", 5), fm.cppn_params_to_list(model),
                               {"coeff": model.fourier_coefficients_pts}, x)
    raw.square().mean().backward()
    torch.cuda.synchronize()
    assert fe.enc_fwd_launches == 1 and fe.enc_bwd_launches == 1
    assert fm.fwd_launches == 0 and fm.bwd_launches == 0
    assert x.grad is not None and model.fourier_coefficients_pts.grad is not None


def test_enc_input_wider_than_the_layer_raises(dev):
    _, packed, a, w = _enc_model(1, 32, "fourier", 5, dev)  # KE = 48 > F = 32
    with pytest.raises(ValueError, match="KE"):
        fe.fused_mlp_enc_fwd_cuda(packed, a, w, torch.zeros((10, 3), device=dev))


@pytest.mark.parametrize("kind", ["fourier", "barf"])
def test_encoded_train_step_on_card(dev, monkeypatch, kind):
    """An encoded split step on the card: the encoded pair launches for the
    grid update and the step, never fused_mlp or fused_step, and never the
    plain version."""
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_sphere_volume,
    )
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs
    from nerf_for_angiography_tpu_torch.training import (
        TrainConfig, create_train_state, make_train_step,
    )

    def plain_refused(*args, **kwargs):
        raise AssertionError("the plain encoded version ran on the card")

    monkeypatch.setattr(fe, "fused_mlp_enc_fwd_reference", plain_refused)
    monkeypatch.setattr(fe, "fused_mlp_enc_bwd_reference", plain_refused)
    ds = generate_dataset(
        make_sphere_volume(res=32), DatagenConfig(limited_size=90.0, number_angles=1.0,
                                                  img_width=16, img_height=16,
                                                  sample_outside=100.0), device=dev,
    )
    cfg = TrainConfig(compact_samples=0, sample_size=16, depth_samples_per_ray=64,
                      grid_resolution=32, pos_enc=kind, barf_start=0, barf_stop=4,
                      fused_train_step="auto")
    model, state = create_train_state(cfg, device=dev)
    step = make_train_step(model, cfg, 1400.0, 1600.0)
    for mod in (fe, fm, fs):
        mod.reset_counts()
    state, metrics, _, _ = step(state, ds.rays)
    state, metrics, _, _ = step(state, ds.rays)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss/train-pixel-coarse"])
    assert fe.enc_fwd_launches == 3 and fe.enc_bwd_launches == 2  # grid update at step 0
    assert fm.fwd_launches == fm.bwd_launches == fs.fused_step_launches == 0
    assert float(metrics["barf-coarse"]) == (1.25 if kind == "barf" else 0.0)


# ---------------------------------------------------------------------------
# kernel #3: the warpgroup-MMA encoded forward at every (F, KE) it takes
# ---------------------------------------------------------------------------

# every (width, n_basis) whose KE = 16 ceil((4 + 6 L) / 16) <= width: the 26
# (F, KE) instantiations of csrc/fused_mlp_enc.cu
_ENC_FWD_CASES = [(width, n_basis) for width in (16, 32, 48, 64, 80, 96, 112, 128)
                  for n_basis, ke in _ENC_WIDTHS if ke <= width]


def _enc_fwd_check(packed, a, w, x):
    """The encoded forward kernel on x within the forward limits of its plain
    version (max abs <= 2e-2 s, median <= 1e-3 s, s = max(1, max |raw|)) and
    two launches bit-identical; returns the kernel's output."""
    got = fe.fused_mlp_enc_fwd_cuda(packed, a, w, x)
    again = fe.fused_mlp_enc_fwd_cuda(packed, a, w, x)
    want = fe.fused_mlp_enc_fwd_reference(packed, a, w, x)
    torch.cuda.synchronize()
    p = x.shape[0]
    s = max(1.0, float(want.abs().max()))
    err = (got - want).abs()
    assert got.shape == (p,) and bool(torch.isfinite(got).all())
    assert float(err.max()) <= 2e-2 * s and float(err.median()) <= 1e-3 * s, p
    assert torch.equal(got, again), p
    return got


@pytest.mark.parametrize("width,n_basis", _ENC_FWD_CASES)
def test_wgmma_enc_forward_matches_plain(dev, width, n_basis):
    """Kernel #3 at every (F, KE), fourier and BARF (alpha 2.7), with 0 / 2
    hidden layers, at ragged P and P below one 64-point tile."""
    for i, kind in enumerate(("fourier", "barf")):
        _, packed, a, w = _enc_model(2 * i, width, kind, n_basis, dev, seed=width + n_basis)
        gen = torch.Generator().manual_seed(4 + i)
        for p in _WGMMA_PS:
            _enc_fwd_check(packed, a, w, (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev))


@pytest.mark.parametrize("p", [1, 63, 65, 64 * 300 + 5])
@pytest.mark.parametrize("kind", ["fourier", "barf"])
def test_wgmma_enc_forward_ragged(dev, kind, p):
    """Kernel #3 at 4 x 128, L = 5 on a ragged last tile: rows past P are
    never stored (the output is exactly P long and matches the plain
    version), and the first P rows of a longer input give the same values."""
    _, packed, a, w = _enc_model(4, 128, kind, 5, dev)
    x = (torch.rand((p + 64, 3), generator=torch.Generator().manual_seed(p)) * 2 - 1).to(dev)
    got = _enc_fwd_check(packed, a, w, x[:p].contiguous())
    assert torch.equal(got, fe.fused_mlp_enc_fwd_cuda(packed, a, w, x)[:p])


def test_wgmma_enc_forward_barf_alpha_zero(dev):
    """BARF at alpha 0: every sin / cos feature is 0, so the kernel's output
    does not depend on W_in's sin / cos columns (bit for bit) and lies within
    the forward limits of kernel #1 on the coordinates alone."""
    model, packed, a, w = _enc_model(4, 128, "barf", 5, dev, alpha=0.0)
    assert bool((w == 0).all())
    x = (torch.rand((64 * 41 + 63, 3), generator=torch.Generator().manual_seed(5)) * 2
         - 1).to(dev)
    got = _enc_fwd_check(packed, a, w, x)
    w_in = packed.w_in.clone()
    w_in[:, 3:] = torch.randn(w_in[:, 3:].shape, generator=torch.Generator().manual_seed(6)).to(
        dev, torch.bfloat16)
    assert torch.equal(got, fe.fused_mlp_enc_fwd_cuda(packed._replace(w_in=w_in), a, w, x))
    (w_x, b_in), *rest = fm.cppn_params_to_list(model)
    coords = fm.pack_params([(w_x[:3], b_in), *rest])
    want = fm.fused_mlp_fwd_cuda(coords, x)
    s = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 2e-2 * s
    assert float((got - want).abs().median()) <= 1e-3 * s


def test_enc_forward_failure_raises(dev, monkeypatch):
    """No fallback for kernel #3: a launch that fails and a build that
    cannot run both raise, and the plain version never runs on the card."""
    from nerf_for_angiography_tpu_torch.ops.kernels import build

    def plain_refused(*args, **kwargs):
        raise AssertionError("the plain encoded forward ran on the card")

    monkeypatch.setattr(fe, "fused_mlp_enc_fwd_reference", plain_refused)
    _, packed, a, w = _enc_model(2, 64, "barf", 5, dev)
    x = torch.rand((1000, 3), device=dev) * 2 - 1
    lib = fe._load_lib()

    class FailingLaunch:
        def __getattr__(self, name):
            return getattr(lib, name)

        def fused_mlp_enc_fwd(self, *args):
            return 1  # cudaErrorInvalidValue

    fe.reset_counts()
    monkeypatch.setattr(fe, "_lib", FailingLaunch())
    with pytest.raises(RuntimeError, match="launch failed"):
        fe.fused_mlp_enc_fwd(packed, a, w, x)
    monkeypatch.setattr(fe, "_lib", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "Path", lambda p: type("P", (), {"exists": lambda self: False})())
    monkeypatch.setattr(build, "source_tag", lambda source: "not-built")
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.fused_mlp_enc_fwd(packed, a, w, x)
    assert fe.enc_fwd_launches == 0


# ---------------------------------------------------------------------------
# the LCA slice on the card: SDF DRRs, the resume checkpoint of CUDA tensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta,phi", [(0.0, 0.0), (25.0, 25.0), (112.5, 112.5)])
def test_sdf_render_drr_card_matches_cpu(dev, theta, phi):
    """render_drr(mode='sdf') on the card against device='cpu' on the same
    LCA volume, rays and depths (the source at z = 4000): within 1e-5."""
    from nerf_for_angiography_tpu_torch.data import make_lca_sdf_volume, render_drr
    from nerf_for_angiography_tpu_torch.data.datasets import sdf_datagen_config
    from nerf_for_angiography_tpu_torch.geometry import get_ray_values, linspace_depths

    cfg = sdf_datagen_config(img_width=40, img_height=36)
    vol = make_lca_sdf_volume(res=48)
    o, d, _ = get_ray_values(theta, phi, 0.0, cfg.src_pt, 40, 36, cfg.focal_length, device=dev)
    z = linspace_depths(cfg.near_thresh, cfg.far_thresh, cfg.depth_samples_per_ray, dev)
    card = render_drr(vol.to(dev), o, d, z, "sdf")
    assert card.is_cuda and card.shape == (36, 40)
    cpu = render_drr(vol, o.cpu(), d.cpu(), z.cpu(), "sdf")
    assert float((card.cpu() - cpu).abs().max()) <= 1e-5
    assert float(cpu.min()) < 0.5 < float(cpu.max())


def test_stratified_lca_sweep_is_the_same_every_call_on_the_card(dev):
    """The stratified LCA sweep on the card without a generator: the same
    images and rays in two calls, with the global CUDA RNG drawn from in
    between (the default generator is seeded with 0)."""
    from nerf_for_angiography_tpu_torch.data import generate_dataset, make_lca_sdf_volume
    from nerf_for_angiography_tpu_torch.data.datasets import sdf_datagen_config

    vol, cfg = make_lca_sdf_volume(res=48), sdf_datagen_config(img_width=40, img_height=36)
    a = generate_dataset(vol, cfg, device=dev)
    torch.rand(1000, device=dev)
    b = generate_dataset(vol, cfg, device=dev)
    np.testing.assert_array_equal(a.images, b.images)
    assert torch.equal(a.rays.pixel_values, b.rays.pixel_values)
    assert torch.equal(a.rays.weights, b.rays.weights)


def test_checkpoint_round_trip_of_cuda_tensors(dev, tmp_path):
    """CheckpointManager saves a trained state of CUDA tensors and restores
    it into a fresh state on the card: every tensor and the generator state
    equal, and the next step of both bit for bit the same."""
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_sphere_volume,
    )
    from nerf_for_angiography_tpu_torch.training import (
        CheckpointManager, TrainConfig, create_train_state, make_train_step,
    )

    ds = generate_dataset(
        make_sphere_volume(res=32), DatagenConfig(limited_size=90.0, number_angles=1.0,
                                                  img_width=16, img_height=16,
                                                  sample_outside=100.0), device=dev,
    )
    cfg = TrainConfig(compact_samples=0, sample_size=16, depth_samples_per_ray=64,
                      grid_resolution=32)
    model, state = create_train_state(cfg, device=dev)
    step = make_train_step(model, cfg, 1400.0, 1600.0)
    for _ in range(3):
        state, *_ = step(state, ds.rays)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state)
    model2, fresh = create_train_state(cfg, seed=11, device=dev)
    restored = mgr.restore(fresh)
    assert restored.step == 3 and restored.grid.occs.is_cuda
    pairs = [(restored.model.state_dict(), state.model.state_dict())]
    for name in ("grid", "vessel_grid"):
        pairs.append(({k: v for k, v in getattr(restored, name)._asdict().items() if v is not None},
                      {k: v for k, v in getattr(state, name)._asdict().items() if v is not None}))
    for got, want in pairs:
        assert set(got) == set(want)
        for k in want:
            assert got[k].device == want[k].device and torch.equal(got[k], want[k]), k
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(restored.optimizer.state_dict()["state"][i][k], v), (i, k)
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    _, _, p_a, _ = step(state, ds.rays)
    _, _, p_b, _ = make_train_step(model2, cfg, 1400.0, 1600.0)(restored, ds.rays)
    assert torch.equal(p_a, p_b)


# ---------------------------------------------------------------------------
# the chunked train step: each step one replay of a captured CUDA graph
# ---------------------------------------------------------------------------

GRAPH_KINDS = {
    "dense": dict(compact_samples=0),
    "lattice": dict(compact_samples=24, march_mode="lattice"),
    "two_bucket": dict(march_mode="hybrid", compact_samples=24, hybrid_w_cap=48,
                       hybrid_w_lo=24, hybrid_k_lo=12),
    "fused": dict(compact_samples=24, march_mode="lattice", fused_train_step="on"),
    "fourier": dict(compact_samples=24, march_mode="lattice", pos_enc="fourier"),
    "barf": dict(compact_samples=0, pos_enc="barf", barf_start=200, barf_stop=300),
}
_NEAR, _FAR = 1400.0, 1600.0


def _sphere_rays(dev):
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_sphere_volume,
    )

    return generate_dataset(
        make_sphere_volume(res=32), DatagenConfig(limited_size=90.0, number_angles=1.0,
                                                  img_width=16, img_height=16,
                                                  sample_outside=100.0), device=dev,
    ).rays


def _graph_state(dev, kind, step=244, **cfg_kw):
    """A small state of ``kind`` after one eager step (the Adam state
    exists), set to ``step``; grid updates every 4 steps, so 36 steps from
    244 cross dense updates, step 256 and all four slabs, slabs 0 and 1
    twice."""
    from nerf_for_angiography_tpu_torch.training import (
        TrainConfig, create_train_state, make_train_step,
    )

    rays = _sphere_rays(dev)
    cfg = TrainConfig(**{**dict(sample_size=16, depth_samples_per_ray=64, grid_resolution=32,
                                grid_update_every=4), **GRAPH_KINDS[kind], **cfg_kw})
    model, state = create_train_state(cfg, device=dev)
    make_train_step(model, cfg, _NEAR, _FAR)(state, rays)
    state.step = step
    return cfg, state, rays


def _state_tensors(state) -> dict:
    out = {f"param/{n}": p for n, p in state.model.named_parameters()}
    opt = state.optimizer
    for i, p in enumerate(opt.param_groups[0]["params"]):
        out.update({f"adam/{i}/{k}": v for k, v in opt.state[p].items()})
    out["lr"] = opt.param_groups[0]["lr"]
    for name in ("grid", "vessel_grid"):
        out.update({f"{name}/{k}": v for k, v in getattr(state, name)._asdict().items()
                    if v is not None})
    out["generator"] = state.generator.get_state()
    out["step_dev"] = state.step_dev
    return out


def _all_counts():
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs

    return (fm.fwd_launches, fm.bwd_launches, fk.launches, fs.fused_step_launches,
            fe.enc_fwd_launches, fe.enc_bwd_launches)


def _reset_counts():
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs

    for mod in (fm, fk, fs, fe):
        mod.reset_counts()


@pytest.mark.parametrize("kind", sorted(GRAPH_KINDS))
def test_replayed_steps_equal_eager_steps(dev, kind):
    """36 steps of make_train_chunk (each a replay of the graph of its grid
    kind, after one eager warm-up a kind) and 36 eager steps from a copy of
    the same state: parameters, Adam state, lr, grids, generator, step
    counters, the last metrics and pixels bit for bit, and every launch
    counter the same (a replay counts its launches, a capture none)."""
    from nerf_for_angiography_tpu_torch.training import (
        copy_state, make_train_chunk, make_train_step,
    )

    cfg, state, rays = _graph_state(dev, kind)
    eager = copy_state(state)
    chunk = make_train_chunk(state.model, cfg, _NEAR, _FAR, 36)
    _reset_counts()
    _, m_g, p_g, t_g = chunk(state, rays)
    torch.cuda.synchronize()
    graph_counts = _all_counts()
    step = make_train_step(eager.model, cfg, _NEAR, _FAR)
    _reset_counts()
    for _ in range(36):
        _, m_e, p_e, t_e = step(eager, rays)
    torch.cuda.synchronize()
    assert graph_counts == _all_counts()
    # one warm-up a kind, then replays: none, dense, slabs 0 and 1 (slabs 2
    # and 3 come once)
    assert chunk.captures == 4 and state.step == eager.step == 280
    assert sorted(map(str, chunk.graphs)) == ["0", "1", "None", "dense"]
    got, want = _state_tensors(state), _state_tensors(eager)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert m_g.keys() == m_e.keys()
    for k in m_g:
        assert torch.equal(m_g[k], m_e[k]), k
    assert torch.equal(p_g, p_e) and torch.equal(t_g, t_e)


def test_capture_runs_no_step(dev):
    """A capture moves nothing: after the warm-up and the capture of one
    kind, the step, the generator and the counters are where the warm-up
    left them until the replay; each replay then counts its launches."""
    from nerf_for_angiography_tpu_torch.training import make_train_chunk

    cfg, state, rays = _graph_state(dev, "lattice", step=245)  # no grid update
    chunk = make_train_chunk(state.model, cfg, _NEAR, _FAR, 1)
    _reset_counts()
    chunk(state, rays)  # the warm-up
    torch.cuda.synchronize()
    one = _all_counts()
    gen = state.generator.get_state()
    params = [p.detach().clone() for p in state.model.parameters()]
    kind = chunk.kind_of(state)
    chunk.graphs[kind] = chunk._capture(kind, state, rays)
    torch.cuda.synchronize()
    assert state.step == 246 and int(state.step_dev) == 246 and _all_counts() == one
    assert torch.equal(state.generator.get_state(), gen)
    assert all(torch.equal(a, b) for a, b in zip(params, state.model.parameters()))
    chunk(state, rays)
    torch.cuda.synchronize()
    assert state.step == 247 and _all_counts() == tuple(2 * n for n in one)
    assert not torch.equal(state.generator.get_state(), gen)


def test_broken_capture_raises_and_runs_nothing(dev, monkeypatch):
    """A launcher that synchronizes cannot be captured: the chunk raises
    naming the call, runs no step eagerly in its place, and the card stays
    usable."""
    from nerf_for_angiography_tpu_torch.training import (
        copy_state, make_train_chunk, make_train_step,
    )
    from nerf_for_angiography_tpu_torch.training.graph import GraphCaptureError

    cfg, state, rays = _graph_state(dev, "dense", step=245)
    want = copy_state(state)
    make_train_step(want.model, cfg, _NEAR, _FAR)(want, rays)  # the warm-up alone
    chunk = make_train_chunk(state.model, cfg, _NEAR, _FAR, 2)
    launch = fm.fused_mlp_fwd_cuda

    def syncing(*args, **kwargs):
        torch.cuda.synchronize()
        return launch(*args, **kwargs)

    monkeypatch.setattr(fm, "fused_mlp_fwd_cuda", syncing)
    _reset_counts()
    with pytest.raises(GraphCaptureError, match="synchronize"):
        chunk(state, rays)
    torch.cuda.synchronize()
    assert state.step == want.step == 246 and not chunk.graphs
    assert fm.bwd_launches == 1  # the warm-up's
    got, ref = _state_tensors(state), _state_tensors(want)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    monkeypatch.setattr(fm, "fused_mlp_fwd_cuda", launch)
    _, metrics, _, _ = make_train_step(state.model, cfg, _NEAR, _FAR)(state, rays)
    assert torch.isfinite(metrics["loss/train-pixel-coarse"])


def test_no_graph_is_freed_inside_a_capture(dev):
    """A chunk whose last reference goes into a fresh reference cycle in
    the middle of another chunk's capture, with the collector set to run at
    nearly every allocation: the capture runs with the collector off, so
    the old graph is freed after it (freeing it inside would invalidate the
    capture)."""
    import gc

    from nerf_for_angiography_tpu_torch.training import make_train_chunk

    # no grid update from 1001 to 1004: one graph kind
    cfg, state, rays = _graph_state(dev, "dense", step=1001, grid_update_every=1000)
    old = make_train_chunk(state.model, cfg, _NEAR, _FAR, 2)
    old(state, rays)  # 1001 warms up, 1002 is captured and replayed
    assert old.captures == 1
    doomed = [old]
    del old
    chunk = make_train_chunk(state.model, cfg, _NEAR, _FAR, 2)
    body = chunk.body

    def body_dropping_a_graph(st, r, acc):
        if torch.cuda.is_current_stream_capturing() and doomed:
            box = [doomed.pop()]
            box.append(box)  # the old chunk now lives in a young cycle only
            del box
        return body(st, r, acc)

    chunk.body = body_dropping_a_graph
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        chunk(state, rays)  # 1003 warms up, 1004 is captured
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()
    torch.cuda.synchronize()
    assert chunk.captures == 1 and state.step == 1005 and not doomed


def test_kernel_launches_inside_a_capture(dev):
    """Each kernel's first launch at a shape can be captured (no launcher
    call that capture forbids); the replay gives the eager launch's result,
    and the counters count the replays, not the capture."""
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs
    from nerf_for_angiography_tpu_torch.training.graph import (
        add_launches, captured_launches,
    )

    _, packed = _packed(4, 128, dev, seed=5)
    _, e_packed, a, w = _enc_model(4, 128, "fourier", 5, dev, seed=5)
    gen = torch.Generator().manual_seed(3)
    x = (torch.rand((3001, 3), generator=gen) * 2 - 1).to(dev)
    g = torch.randn((3001,), generator=gen).to(dev)
    mask = (torch.rand((300, 77), generator=gen) < 0.4).to(torch.float32).to(dev)
    o, d, t_mid, m, tgt = _march_inputs(211, 40, dev, eps_scale=1.5)
    kw = dict(step=1.5, early_stop_eps=1e-2, n_rays_loss=211, input_scale=0.9)
    launches = {
        "fwd": lambda: fm.fused_mlp_fwd_cuda(packed, x),
        "bwd": lambda: fm.fused_mlp_bwd_cuda(packed, x, g),
        "enc_fwd": lambda: fe.fused_mlp_enc_fwd_cuda(e_packed, a, w, x),
        "enc_bwd": lambda: fe.fused_mlp_enc_bwd_cuda(e_packed, a, w, x, g),
        "first_k": lambda: fk.first_k_active_cuda(mask, 29),
        "fused_step": lambda: fs.fused_step_grads_cuda(packed, o, d, t_mid, m, tgt, **kw),
    }

    def flat(out):
        if torch.is_tensor(out):
            return [out]
        return [t for item in out for t in flat(item)]

    for name, launch in launches.items():
        graph = torch.cuda.CUDAGraph()
        _reset_counts()
        with captured_launches() as tally, torch.cuda.graph(graph):
            out = launch()
        assert _all_counts() == (0,) * 6 and sum(tally.values()) == 1, name
        want = [t.clone() for t in flat(launch())]
        before = _all_counts()
        graph.replay()
        add_launches(tally)
        torch.cuda.synchronize()
        assert sum(_all_counts()) == sum(before) + 1, name
        for got_t, want_t in zip(flat(out), want):
            assert torch.equal(got_t, want_t), name


def test_resumed_run_replays_from_the_restored_state(dev, tmp_path, capsys, monkeypatch):
    """A run resumed from its checkpoint trains through replayed graphs,
    and a chunk on a restored state (its Adam state loaded anew) equals the
    eager steps from another restore of the same checkpoint bit for bit."""
    from nerf_for_angiography_tpu_torch.training import (
        CheckpointManager, TrainConfig, create_train_state, make_train_chunk,
        make_train_step, train,
    )

    import importlib

    loop = importlib.import_module("nerf_for_angiography_tpu_torch.training.loop")
    chunks = []
    make = loop.make_train_chunk

    def recording(*args, **kwargs):
        chunks.append(make(*args, **kwargs))
        return chunks[-1]

    monkeypatch.setattr(loop, "make_train_chunk", recording)
    rays = _sphere_rays(dev)
    cfg = TrainConfig(sample_size=16, depth_samples_per_ray=64, grid_resolution=32,
                      compact_samples=24, n_iters=40, display_every=20, early_stop_iters=10**6)
    log_dir = str(tmp_path / "run")
    train(cfg, rays, src_pt_z=1500.0, log_dir=log_dir, checkpoint_every=20, device=dev)
    assert sum(c.captures for c in chunks) > 0
    chunks.clear()
    res = train(dataclasses.replace(cfg, n_iters=80), rays, src_pt_z=1500.0, log_dir=log_dir,
                checkpoint_every=20, device=dev)
    assert "resumed from checkpoint at step 41" in capsys.readouterr().out
    assert sum(c.captures for c in chunks) > 0
    assert res.state.step == 81 and np.isfinite(res.last_psnr)
    mgr = CheckpointManager(str(tmp_path / "run" / "ckpt"))
    (_, a), (_, b) = (create_train_state(cfg, seed=s, device=dev) for s in (5, 6))
    a, b = mgr.restore(a), mgr.restore(b)
    assert a.step == b.step == 81
    chunk = make_train_chunk(a.model, cfg, _NEAR, _FAR, 20)
    _, _, p_a, _ = chunk(a, rays)
    step = make_train_step(b.model, cfg, _NEAR, _FAR)
    for _ in range(20):
        _, _, p_b, _ = step(b, rays)
    assert chunk.captures > 0 and torch.equal(p_a, p_b)
    got, want = _state_tensors(a), _state_tensors(b)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# evaluation and export on the card
# ---------------------------------------------------------------------------


def _eval_model_grid(dev, outside=100.0, bias=-5.0, gain=4.0, res=32):
    """A 4x128 CPPN whose head is shifted and scaled so the sweep's renders
    are neither black nor white, and a grid of a few occupied balls."""
    from nerf_for_angiography_tpu_torch.ops.occupancy import grid_from_numpy

    gen = torch.Generator().manual_seed(3)
    model = CPPN(CPPNConfig(num_early_layers=4, num_filters=128, input_scale=1.0 / outside,
                            dtype=torch.bfloat16), generator=gen)
    with torch.no_grad():
        model.output_linear.weight.mul_(gain)
        model.output_linear.bias.add_(bias)
    rng = np.random.default_rng(1)
    idx = np.stack(np.meshgrid(*[np.arange(res) + 0.5] * 3, indexing="ij"), -1)
    binary = np.zeros((res,) * 3, bool)
    for _ in range(6):
        c, r = rng.uniform(0.2, 0.8, 3) * res, rng.uniform(0.1, 0.2) * res
        binary |= ((idx - c) ** 2).sum(-1) < r * r
    aabb = [-outside] * 3 + [outside] * 3
    model.requires_grad_(False)
    return model.to(dev), grid_from_numpy(binary, aabb, occs=binary.astype(np.float32),
                                          device=dev)


@pytest.mark.parametrize("branch", ["ct", "lca"])
def test_sweep_batch_on_the_card_matches_the_cpu(dev, branch):
    """The batch renderer on the card (kernel #1, first-k in the CT branch's
    compacted lattice march) against the same batch on the CPU (the plain
    versions): pixels within the port's render tolerance, 2e-2."""
    import copy

    from nerf_for_angiography_tpu_torch.evaluation import (
        EvalConfig, lca_eval_config, make_batch_view_renderer,
    )

    if branch == "ct":
        cfg = EvalConfig(img_width=24, img_height=20)
        model, grid = _eval_model_grid(dev)
    else:
        cfg = lca_eval_config(img_width=24, img_height=20, depth_samples_per_ray=64)
        model, grid = _eval_model_grid(dev, outside=80.0, bias=-26.0, gain=20.0)
    thetas, phis = [30.0, 300.0, 0.0, 180.0], [45.0, 10.0, 0.0, 270.0]
    fk.reset_counts()
    fm.reset_counts()
    px, bpx, c2w = make_batch_view_renderer(model, grid, cfg)(grid, thetas, phis)
    torch.cuda.synchronize()
    assert fm.fwd_launches == 1 and fk.launches == (1 if branch == "ct" else 0)
    grid_cpu = type(grid)(*(t.cpu() if t is not None else None for t in grid))
    cpx, cbpx, cc2w = make_batch_view_renderer(copy.deepcopy(model).cpu(), grid_cpu, cfg)(
        grid_cpu, thetas, phis)
    assert 0.02 < float(cpx.mean()) < 0.98
    for a, b in ((px, cpx), (bpx, cbpx)):
        err = (a.cpu() - b).abs()
        assert float(err.max()) <= 2e-2 and float(err.median()) <= 1e-3
    torch.testing.assert_close(c2w.cpu(), cc2w)


def test_first_k_at_the_ct_sweep_shape(dev):
    """First-k at the CT sweep's batch shape (4 views of 100x100 rays, 200
    samples, k = 96) equal to its plain version."""
    gen = torch.Generator().manual_seed(2)
    mask = (torch.rand((40_000, 200), generator=gen) < 0.3).float()
    mask[:100] = 1.0
    mask[100:200] = 0.0
    mask = mask.to(dev)
    sel, mk = fk.first_k_active_cuda(mask, 96)
    want_sel, want_mk = fk.first_k_active_reference(mask, 96)
    assert torch.equal(sel, want_sel) and torch.equal(mk, want_mk)


def test_sweep_on_the_card_launch_counts(dev, tmp_path):
    """A small run_sweep on the card: kernel #1 once a batch and once a
    field chunk, first-k once a CT batch, the other kernels never; every
    artifact written."""
    import os

    from nerf_for_angiography_tpu_torch.data import make_sphere_volume
    from nerf_for_angiography_tpu_torch.evaluation import EvalConfig, gt_from_volume, run_sweep
    from nerf_for_angiography_tpu_torch.ops.interpolation import trilinear
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_step as fs

    model, grid = _eval_model_grid(dev)
    cfg = EvalConfig(limited_size_vis=180.0, number_angles_vis=4.0, img_width=32,
                     img_height=32, field_resolution=70, save_videos=False,
                     save_heatmap=False)
    vol = make_sphere_volume(res=24, device=dev)
    for mod in (fm, fk, fe, fs):
        mod.reset_counts()
    table = run_sweep(model, grid, cfg, gt_from_volume(vol, cfg), str(tmp_path), verbose=False,
                      gt_volume_sampler=lambda p: trilinear(vol, p), device=dev)
    torch.cuda.synchronize()
    # 25 views in 7 batches of 4; 70^3 = 343,000 points in 2 chunks
    assert (fm.fwd_launches, fk.launches) == (7 + 2, 7)
    assert (fm.bwd_launches, fe.enc_fwd_launches, fe.enc_bwd_launches,
            fs.fused_step_launches) == (0, 0, 0, 0)
    assert table["pred_img"].shape == (25, 32 * 32) and np.isfinite(table["PSNR"]).all()
    names = set(os.listdir(tmp_path))
    assert {"df-metrics.csv", "metrics-summary.txt", "coarse-field.vtk", "projections"} <= names
    assert len(os.listdir(tmp_path / "projections")) == 50


def test_reconstruction_on_the_card(dev, tmp_path):
    """Reconstruction.from_run_dir onto the card: render_view equal to the
    sweep's render_view_pair bit for bit, and within 2e-2 of the same run
    directory loaded onto the CPU; the density field within the forward
    tolerance."""
    from nerf_for_angiography_tpu_torch.evaluation import EvalConfig, render_view_pair
    from nerf_for_angiography_tpu_torch.reconstruction import Reconstruction
    from nerf_for_angiography_tpu_torch.training import save_grid_vtk, save_model

    model, grid = _eval_model_grid(dev)
    save_model(str(tmp_path / "highmodel.npz"), model.config.to_model_definition(), model)
    save_grid_vtk(str(tmp_path / "highgrid.vtk"), grid)
    cfg = EvalConfig(img_width=24, img_height=20)
    rec = Reconstruction.from_run_dir(str(tmp_path), eval_config=cfg)
    assert rec.device.type == "cuda"
    cpu = Reconstruction.from_run_dir(str(tmp_path), eval_config=cfg, device="cpu")
    img = rec.render_view(-30.0, 45.0)
    pair, _, _ = render_view_pair(rec.model, rec.grid, cfg, 330.0, 45.0)
    np.testing.assert_array_equal(img, pair)
    np.testing.assert_allclose(img, cpu.render_view(-30.0, 45.0), atol=2e-2)
    np.testing.assert_allclose(rec.density_field(resolution=17),
                               cpu.density_field(resolution=17), atol=2e-2)


@pytest.mark.parametrize("native_loader", [True, False], ids=["native", "csv"])
def test_csv_round_trip_of_a_card_dataset(dev, tmp_path, native_loader):
    """A dataset generated on the card, written to the two CSVs and read back
    by load_data onto the card: every ray array equal bit for bit."""
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, load_data, make_vessel_volume, write_proj_csv,
        write_rays_csv,
    )

    ds = generate_dataset(make_vessel_volume(res=32, device=dev),
                          DatagenConfig(limited_size=90.0, number_angles=2.0, img_width=24,
                                        img_height=20, sample_outside=40.0))
    write_proj_csv(ds, str(tmp_path / "proj.csv"))
    write_rays_csv(ds, str(tmp_path / "rays.csv"))
    got = load_data(str(tmp_path / "proj.csv"), str(tmp_path / "rays.csv"),
                    use_native=native_loader)
    assert got.rays_per_view == 24 * 20 and got.num_views == 10
    for f in ("origins", "directions", "pixel_values", "weights", "image_ids", "x_positions",
              "y_positions"):
        a, b = getattr(got.rays, f), getattr(ds.rays, f)
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b), f


def test_cli_pipeline_on_the_card(dev, tmp_path, monkeypatch):
    """datagen -> train -> evaluate through the entry points at their default
    device, at the CPU test's tiny sizes: the run directory, df-metrics.csv
    and the cag-vis JSONs written, kernels #1 and #2 launched by the
    training, #1 by the sweep; load_experiments reads the run back."""
    import importlib.util
    import os

    from nerf_for_angiography_tpu_torch.analysis import load_experiments
    from nerf_for_angiography_tpu_torch.cli import datagen, evaluate, train

    monkeypatch.chdir(tmp_path)
    datagen.main(["--limited_size", "90", "--number_angles", "2", "--img_size", "16",
                  "--volume", "phantom:sphere", "--out", "data"])
    fm.reset_counts()
    res = train.main(["--n_iters", "30", "--grid_resolution", "8", "--depth_samples", "32",
                      "--display_every", "15"])
    torch.cuda.synchronize()
    assert fm.fwd_launches > 0 and fm.bwd_launches == 31 and np.isfinite(res.last_psnr)
    fm.reset_counts()
    extra = [] if importlib.util.find_spec("matplotlib") else ["--no_heatmap_png"]
    tables = evaluate.main(["--data_name", "ct", "--volume", "phantom:sphere",
                            "--number_angles_vis", "2", "--img_size", "16", "--depth_samples",
                            "32", "--field_resolution", "9", "--no_videos", "--no_perceptual"]
                           + extra)
    torch.cuda.synchronize()
    (rd, table), = tables.items()
    assert fm.fwd_launches > 0 and fm.bwd_launches == 0
    assert np.isfinite(table["PSNR"]).all() and len(table["PSNR"]) == 9
    assert os.path.exists(os.path.join(rd, "df-metrics.csv"))
    assert any(f.endswith(".json") for _, _, fs in os.walk(os.path.join(rd, "jsonData"))
               for f in fs)
    assert load_experiments("cases")["run"] == [os.path.basename(rd)]


def _trained_pose_state(dev, **cfg_kw):
    """A small pose-refined state after 121 train() steps (pose_start 20)
    on shifted views of the vessel phantom with rays from the nominal
    cameras; its rays without the test view."""
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_vessel_volume,
    )
    from nerf_for_angiography_tpu_torch.training import TrainConfig, drop_test_view, train

    ds = generate_dataset(make_vessel_volume(res=32), DatagenConfig(
        limited_size=90.0, number_angles=1.0, img_width=24, img_height=24, sample_outside=100.0,
        stratified_depths=False, max_shift_translation=0.05, rays_from_nominal=True), device=dev)
    cfg = TrainConfig(**{**dict(sample_size=24, depth_samples_per_ray=64, grid_resolution=32,
                                grid_update_every=4, pose_refine=True, pose_start=20,
                                n_iters=120, display_every=40), **cfg_kw})
    res = train(cfg, ds.rays, 1500.0, verbose=False, device=dev)
    return cfg, res.state, drop_test_view(ds.rays, 4, 576)


@pytest.mark.parametrize("pos_enc", ["none", "fourier"])
def test_pose_step_dx_at_its_own_g_matches_plain(dev, pos_enc):
    """At a trained pose state, on the upstream gradient g a pose step hands
    the MLP backward: the kernel's (#2, or #4 for fourier) dx against its
    plain version's (beyond 3e-2 of the plain max on at most 2e-5 of the
    points: relu ties), and the kernel leaves dx 0 on tiles of zero g."""
    import importlib

    tt = importlib.import_module("nerf_for_angiography_tpu_torch.training.train")
    from nerf_for_angiography_tpu_torch.ops.sampling import sample_pixel_rays

    cfg, state, rays = _trained_pose_state(dev, pos_enc=pos_enc)
    model = state.model
    batch = sample_pixel_rays(state.generator, rays, cfg.img_sample_size)
    origins = tt.shifted_origins(model, batch).detach()
    m = tt._march_for(cfg, state.grid, origins, batch.directions, _NEAR, _FAR)
    pts = (tt._flat_positions(m) * model.config.input_scale).detach().contiguous()
    plist = fm.cppn_params_to_list(model)
    x = pts.clone().requires_grad_(True)
    if pos_enc == "none":
        raw = fm.fused_mlp_raw(plist, x)
    else:
        raw = fe.fused_mlp_enc_raw(("fourier", 5), plist,
                                   {"coeff": model.fourier_coefficients_pts}, x)
    sig = torch.sigmoid(raw).reshape(m.mask.shape)
    dists, keep = tt._keep_mask(m, sig, cfg)
    pix = torch.exp(-(sig * keep * dists).sum(-1))
    loss = torch.mean((pix - batch.pixel_values) ** 2)
    g = torch.autograd.grad(loss, raw)[0].contiguous()
    if pos_enc == "none":
        packed = fm.pack_params(plist)
        _, dx_k = fm.fused_mlp_bwd_cuda(packed, pts, g)
        _, dx_p = fm.fused_mlp_bwd_reference(packed, pts, g)
    else:
        packed = fe.pack_enc_params(plist, 5)
        a, w = (t.contiguous() for t in fe.enc_arrays("fourier", 5,
                                                       model.fourier_coefficients_pts.detach()))
        _, _, dx_k = fe.fused_mlp_enc_bwd_cuda(packed, a, w, pts, g)
        _, _, dx_p = fe.fused_mlp_enc_bwd_reference(packed, a, w, pts, g)
    assert float(g.abs().max()) > 0 and float(dx_p.abs().max()) > 0
    bad = ((dx_k - dx_p).abs() > 3e-2 * dx_p.abs().max()).any(-1)
    assert float(bad.float().mean()) <= 2e-5
    zero_tiles = ~torch.nn.functional.pad(g != 0, (0, (-g.numel()) % 16)).reshape(-1, 16).any(1)
    skipped = zero_tiles.repeat_interleave(16)[: g.numel()]
    assert bool((dx_k[skipped] == 0).all())


def test_replayed_pose_steps_equal_eager_steps(dev):
    """A trained pose state: 24 steps of make_train_chunk (replays, across
    grid updates) and 24 eager steps from a copy: every parameter (the view
    shifts among them), both AdamW groups' state and lr, the grids, the
    generator, the last metrics and pixels bit for bit."""
    from nerf_for_angiography_tpu_torch.training import (
        copy_state, make_train_chunk, make_train_step,
    )

    cfg, state, rays = _trained_pose_state(dev)
    eager = copy_state(state)
    chunk = make_train_chunk(state.model, cfg, _NEAR, _FAR, 24)
    _, m_g, p_g, _ = chunk(state, rays)
    step = make_train_step(eager.model, cfg, _NEAR, _FAR)
    for _ in range(24):
        _, m_e, p_e, _ = step(eager, rays)
    torch.cuda.synchronize()
    assert chunk.captures >= 1
    for (n, a), b in zip(state.model.named_parameters(), eager.model.parameters()):
        assert torch.equal(a, b), n
    assert len(state.optimizer.param_groups) == 2
    for ga, gb in zip(state.optimizer.param_groups, eager.optimizer.param_groups):
        assert torch.equal(ga["lr"], gb["lr"])
        for pa, pb in zip(ga["params"], gb["params"]):
            for k, v in eager.optimizer.state[pb].items():
                assert torch.equal(state.optimizer.state[pa][k], v), k
    for name in ("grid", "vessel_grid"):
        for a, b in zip(getattr(state, name), getattr(eager, name)):
            assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(state.generator.get_state(), eager.generator.get_state())
    assert torch.equal(p_g, p_e)
    for k in m_g:
        assert torch.equal(m_g[k], m_e[k]), k


def test_a_fresh_state_keeps_its_graphs_across_calls(dev):
    """make_train_chunk called again and again from a fresh state (the
    JAX-style loop of chunk calls): the first call's warm-up steps create
    the Adam state, and the graphs captured after them stay valid, so the
    next calls replay them. (Before, the second call compared the state's
    tensors with the ones the first call began with, dropped its graphs and
    captured again into the same memory pool while the caller held the last
    replay's metrics: the allocator's capture_begin asserted.)"""
    from nerf_for_angiography_tpu_torch.training import (
        TrainConfig, create_train_state, make_train_chunk,
    )

    rays = _sphere_rays(dev)
    cfg = TrainConfig(sample_size=16, depth_samples_per_ray=64, grid_resolution=32,
                      grid_update_every=100_000)
    model, state = create_train_state(cfg, device=dev)
    chunk = make_train_chunk(model, cfg, _NEAR, _FAR, 10)
    held = [chunk(state, rays)[1] for _ in range(3)]
    torch.cuda.synchronize()
    assert chunk.captures == 1 and state.step == 30
    assert all(torch.isfinite(m["loss/train-pixel-coarse"]) for m in held)
