"""Port on the card: the CUDA kernels against their plain versions at small
and ragged shapes, the launch counters, one dense and one compacted train
step. Skipped without a GPU; on the card run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(this file imports torch only)."""

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
