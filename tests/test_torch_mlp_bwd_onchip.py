"""Kernel #2 on chip (csrc/mlp_onchip.cuh) on the card: against its plain
version, bit-identical over two launches, dx 0 on the skipped tiles, the
ragged edge, the feature-major input, the active-tile counter and the
on-chip launch count; widths wgmma's 64 rows do not divide keep the
two-kernel backward. Skipped without a GPU; on the card run
``python -m pytest --noconftest -m cuda tests/test_torch_mlp_bwd_onchip.py``
(this file imports torch only)."""

import pytest
import torch

from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm

pytestmark = pytest.mark.cuda

TILE = 16


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
    return fm.pack_params(fm.cppn_params_to_list(model.to(dev)))


def _inputs(p, live_share, dev, seed=1):
    """x (P, 3) in [-1, 1), g standard normal on a ``live_share`` of the
    16-point tiles and 0 (some -0) on the others; the bool mask of the
    points in zero tiles."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((p, 3), generator=gen) * 2 - 1
    g = torch.randn((p,), generator=gen)
    n_tiles = -(-p // TILE)
    live = torch.rand((n_tiles,), generator=gen) < live_share
    zero = ~live.repeat_interleave(TILE)[:p]
    g[zero] = 0.0
    g[zero.nonzero()[::7, 0]] = -0.0
    return x.to(dev), g.to(dev), zero.to(dev)


def _min_abs_preact(packed, x):
    """Per point, the smallest |pre-activation| of the plain forward."""
    h = x.to(torch.bfloat16).float()
    dist = torch.full((x.shape[0],), float("inf"), device=x.device)
    for w, b in zip([packed.w_in[:, :3]] + list(packed.w_hid), packed.bias):
        z = h @ w.float().T + b
        dist = torch.minimum(dist, z.abs().amin(dim=1))
        h = torch.relu(z).to(torch.bfloat16).float()
    return dist


def _assert_near_plain(packed, x, g, grads_k, dx_k):
    """test_kernels_match_plain's limits."""
    grads_p, dx_p = fm.fused_mlp_bwd_reference(packed, x, g)
    for (wk, bk), (wp, bp) in zip(grads_k, grads_p):
        for a, b in ((wk, wp), (bk, bp)):
            scale = max(float(b.abs().max()), 1e-12)
            torch.testing.assert_close(a / scale, b.reshape(a.shape) / scale, atol=3e-2, rtol=0)
    rel = float(torch.linalg.norm(dx_k - dx_p) / torch.linalg.norm(dx_p))
    assert rel < 3e-2
    bad = ((dx_k - dx_p).abs() > 3e-2 * dx_p.abs().max()).any(dim=1)
    assert bool((_min_abs_preact(packed, x[bad]) < 1e-3).all())


def _equal(a, b):
    return all(torch.equal(u, v) for pa, pb in zip(a, b) for u, v in zip(pa, pb))


@pytest.mark.parametrize("n_hidden,width,p,live", [
    (4, 128, 1, 1.0), (4, 128, 65, 1.0), (4, 128, 3001, 1.0), (4, 128, 64 * 300 + 5, 0.5),
    (1, 128, 5000, 0.7), (2, 128, 7001, 0.7), (3, 128, 7001, 0.3), (2, 64, 1000, 1.0),
    (4, 64, 9001, 0.6), (8, 64, 9001, 0.6),
])
def test_onchip_backward_matches_plain(dev, n_hidden, width, p, live):
    packed = _packed(n_hidden, width, dev)
    x, g, zero = _inputs(p, live, dev)
    fm.reset_counts()
    grads, dx = fm.fused_mlp_bwd_cuda(packed, x, g)
    grads2, dx2 = fm.fused_mlp_bwd_cuda(packed, x, g)
    torch.cuda.synchronize()
    assert fm.bwd_onchip == fm.bwd_launches == 2
    assert _equal(grads, grads2) and torch.equal(dx, dx2)
    assert bool((dx[zero] == 0).all())
    _assert_near_plain(packed, x, g, grads, dx)


def test_onchip_backward_ragged_and_feature_major(dev):
    """P = 640,063 (ragged, about a third of the tiles live): within the
    plain version's limits, and the (3, P) input gives the (P, 3) input's
    gradients and dx bit for bit."""
    packed = _packed(4, 128, dev)
    x, g, zero = _inputs(640_063, 0.35, dev, seed=4)
    grads, dx = fm.fused_mlp_bwd_cuda(packed, x, g)
    grads_fm, dx_fm = fm.fused_mlp_bwd_cuda(packed, x.T.contiguous(), g, True)
    torch.cuda.synchronize()
    assert _equal(grads, grads_fm) and torch.equal(dx, dx_fm.T)
    assert bool((dx[zero] == 0).all())
    _assert_near_plain(packed, x, g, grads, dx)


def test_onchip_backward_of_a_zero_gradient_is_zero(dev):
    packed = _packed(4, 128, dev)
    x, g, _ = _inputs(64 * 300 + 5, 0.0, dev)
    grads, dx = fm.fused_mlp_bwd_cuda(packed, x, g)
    torch.cuda.synchronize()
    assert all(bool((t == 0).all()) for pair in grads for t in pair)
    assert bool((dx == 0).all())


def test_onchip_backward_counts_the_active_tiles(dev):
    """The card's counter gains the 16-point tiles holding a g != 0 (-0
    counts as zero), a launch and a replay at a time; the host counts one
    on-chip launch each, and its launched tiles and points."""
    packed = _packed(4, 128, dev)
    p = 100_003
    x, g, zero = _inputs(p, 0.4, dev, seed=5)
    live = torch.nn.functional.pad(g != 0, (0, (-p) % TILE)).reshape(-1, TILE).any(dim=1)
    want = int(live.sum())
    counter = fm.active_tiles(dev)
    before = int(counter.item())
    fm.reset_counts()
    fm.fused_mlp_bwd_cuda(packed, x, g)
    torch.cuda.synchronize()
    assert int(counter.item()) - before == want
    assert (fm.bwd_launches, fm.bwd_onchip, fm.bwd_tiles, fm.bwd_points) == (
        1, 1, -(-p // TILE), p)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        grads_g, dx_g = fm.fused_mlp_bwd_cuda(packed, x, g)
    assert fm.bwd_onchip == fm.bwd_launches == 2
    graph.replay()
    torch.cuda.synchronize()
    assert int(counter.item()) - before == 2 * want
    grads, dx = fm.fused_mlp_bwd_cuda(packed, x, g)
    torch.cuda.synchronize()
    assert _equal(grads, grads_g) and torch.equal(dx, dx_g)


def test_width_96_keeps_the_two_kernel_backward(dev):
    """F = 96 is no multiple of wgmma's 64 rows: the two-kernel backward
    runs (no on-chip launch), within the plain version's limits."""
    packed = _packed(2, 96, dev)
    x, g, zero = _inputs(5001, 0.6, dev)
    assert fm._load_lib().fused_mlp_bwd_onchip(96, 2) == 0
    assert fm._load_lib().fused_mlp_bwd_onchip(128, 4) == 1
    fm.reset_counts()
    grads, dx = fm.fused_mlp_bwd_cuda(packed, x, g)
    torch.cuda.synchronize()
    assert (fm.bwd_launches, fm.bwd_onchip) == (1, 0)
    assert bool((dx[zero] == 0).all())
    _assert_near_plain(packed, x, g, grads, dx)
