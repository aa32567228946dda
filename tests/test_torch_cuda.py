"""Port on the card: the CUDA kernels against their plain versions at small
and ragged shapes, the launch counters, one dense and one compacted train
step, the whole-step kernel's train steps and the feature-major layout. Skipped without a GPU; on the card run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(this file imports torch only)."""

import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig
from nerf_for_angiography_tpu_torch.ops.kernels import first_k as fk
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm

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
    h = x.to(torch.bfloat16).float()
    dist = torch.full((x.shape[0],), float("inf"), device=x.device)
    for w, b in zip([packed.w_in[:, :3]] + list(packed.w_hid), packed.bias):
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


def test_sampling_table_repeats_bit_for_bit(dev):
    from nerf_for_angiography_tpu_torch.ops.sampling import build_sampling_table

    w = torch.rand((260_000,), device=dev) + 1e-3
    first = build_sampling_table(w)
    assert first.device.type == "cuda"
    assert all(torch.equal(first, build_sampling_table(w)) for _ in range(5))
