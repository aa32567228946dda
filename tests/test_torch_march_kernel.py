"""Port: the compacted march's kernels (``ops/kernels/march.py`` ->
``csrc/march.cu``) and their dispatch.

On the CPU (tier 1): the stable counting sort the sort kernel runs, as a
plain helper, against ``torch.argsort``, the dispatch rule (which compacted marches
take the kernels on the card), the chain's tally, and the origin gradient the
kernels' positions get in pose refinement. On the card (``cuda``): the
kernels against the op chain, its plain version, at the cells' Tunings,
integers exact and floats bit for bit, pose's view-shift gradient included:
``python -m pytest --noconftest -m cuda tests/test_torch_march_kernel.py``
(this file imports torch only)."""

import dataclasses

import pytest
import torch

from nerf_for_angiography_tpu_torch.ops import occupancy as occ
from nerf_for_angiography_tpu_torch.ops.kernels import first_k as fk
from nerf_for_angiography_tpu_torch.ops.kernels import march as mk
from nerf_for_angiography_tpu_torch.training import TrainConfig
from nerf_for_angiography_tpu_torch.training.train import _march_for, _RowGather


def _counting_sort(key: torch.Tensor, n_bins: int):
    """The sort kernel's stable counting sort in plain PyTorch: int keys in
    [0, n_bins) -> (perm, inv), int64. A key's place is the count of smaller
    keys (the bins' exclusive sum) plus the count of equal keys before it."""
    onehot = torch.nn.functional.one_hot(key.long(), n_bins)
    starts = torch.cumsum(onehot.sum(dim=0), dim=0) - onehot.sum(dim=0)
    before = (torch.cumsum(onehot, dim=0) - onehot).gather(1, key.long()[:, None])[:, 0]
    inv = starts[key.long()] + before
    perm = torch.empty_like(inv)
    perm[inv] = torch.arange(key.shape[0], dtype=inv.dtype, device=key.device)
    return perm, inv


def _keys(kind: str, n_rays: int, n_bins: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    if kind == "random":
        return torch.randint(0, n_bins, (n_rays,), generator=gen)
    if kind == "ties":  # few distinct spans, misses (0) among them
        vals = torch.tensor([0, min(7, n_bins - 1), n_bins - 1])
        return vals[torch.randint(0, 3, (n_rays,), generator=gen)]
    if kind == "all_miss":
        return torch.zeros((n_rays,), dtype=torch.int64)
    if kind == "descending":
        return torch.arange(n_rays).flip(0) % n_bins
    raise ValueError(kind)


@pytest.mark.parametrize("kind,n_rays,n_bins", [
    ("random", 5625, 301), ("ties", 5625, 301), ("all_miss", 5625, 301),
    ("descending", 1000, 301), ("random", 1, 301), ("ties", 333, 2), ("random", 700, 6140),
])
def test_counting_sort_plain_helper_is_the_stable_argsort(kind, n_rays, n_bins):
    key = _keys(kind, n_rays, n_bins, seed=n_rays + n_bins).to(torch.int32)
    perm, inv = _counting_sort(key, n_bins)
    assert perm.dtype == inv.dtype == torch.int64
    assert torch.equal(perm, torch.argsort(key, stable=True))
    assert torch.equal(inv, torch.argsort(perm))


def test_sort_warps_fit_the_shared_memory():
    """The sort kernel's histograms (a warp's n + 1 bins, the bins' starts
    and the scan's words) stay within 48 KB, and n past that takes none."""
    for n in (48, 300, 2000, mk._MAX_SORT_N):
        w = mk.sort_warps(n)
        assert 1 <= w <= 8 and 4 * ((w + 1) * (n + 1) + 8) <= 48 * 1024
    assert mk.sort_warps(300) == 8 and mk.sort_warps(mk._MAX_SORT_N + 1) == 0


def test_takes_kernels_reads_the_device_and_the_shard():
    assert occ.takes_kernels(torch.device("cuda"))
    assert occ.takes_kernels("cuda:1")
    assert not occ.takes_kernels(torch.device("cuda"), shard=(0, 2))
    assert not occ.takes_kernels(torch.device("cpu"))


_SMALL = dict(depth_samples_per_ray=64, grid_resolution=32, outside=100.0, sample_size=16,
              compact_samples=24, occ_stride=1)
# every compacted mode _march_for dispatches: the cells run the lattice and
# hybrid2k; the chooser may pick window, hybrid or hybrid2
_MODES = {
    "lattice": dict(march_mode="lattice"),
    "window": dict(march_mode="window"),
    "hybrid": dict(march_mode="hybrid", hybrid_split=0.0),
    "hybrid2": dict(march_mode="hybrid", hybrid_split=0.75, hybrid_w_lo=24,
                    hybrid_bucket_k=False),
    "hybrid2k": dict(march_mode="hybrid", hybrid_split=0.75, hybrid_w_lo=24, hybrid_k_lo=12),
}


class _Reached(Exception):
    pass


def _rays_and_grid(n_rays=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    d = torch.nn.functional.normalize(torch.randn((n_rays, 3), generator=gen) * 0.05
                                      + torch.tensor([0.0, 0.0, -1.0]), dim=-1)
    o = torch.tensor([0.0, 0.0, 1500.0]) + torch.randn((n_rays, 3), generator=gen) * 5.0
    binary = torch.rand((32, 32, 32), generator=gen) < 0.2
    return o, d, occ.grid_from_numpy(binary.numpy(), [-100.0] * 3 + [100.0] * 3)


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("shard", [None, (0, 2)])
def test_every_compacted_mode_takes_the_kernels_on_the_card(mode, shard, monkeypatch):
    """With the rays on the card (the device test stood in for), every
    compacted mode reaches a march kernel and none the chain; sharded, the
    two-bucket marches keep the chain (the sort and the cut over the whole
    batch) and the ray-by-ray marches march the rank's rows through the
    kernels."""
    monkeypatch.setattr(occ, "takes_kernels", lambda device, shard=None: shard is None)

    def reached(*args, **kwargs):
        raise _Reached

    monkeypatch.setattr(mk, "march_fine_cuda", reached)
    monkeypatch.setattr(mk, "march_buckets_cuda", reached)
    o, d, grid = _rays_and_grid()
    cfg = TrainConfig(**_SMALL, **_MODES[mode])
    chain = mk.march_chain
    if shard is not None and mode.startswith("hybrid2"):
        _march_for(cfg, grid, o, d, 1400.0, 1600.0, shard=shard)
        assert mk.march_chain == chain + 1
    else:
        with pytest.raises(_Reached):
            _march_for(cfg, grid, o, d, 1400.0, 1600.0, shard=shard)
        assert mk.march_chain == chain


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_a_cpu_march_counts_once_on_the_chain(mode):
    o, d, grid = _rays_and_grid()
    mk.reset_counts()
    _march_for(TrainConfig(**_SMALL, **_MODES[mode]), grid, o, d, 1400.0, 1600.0)
    assert (mk.march_chain, mk.march_fused, mk.launches) == (1, 0, 0)


def test_the_dense_lattice_counts_in_neither(monkeypatch):
    monkeypatch.setattr(occ, "takes_kernels", lambda device, shard=None: True)
    o, d, grid = _rays_and_grid()
    mk.reset_counts()
    m = _march_for(TrainConfig(**{**_SMALL, "compact_samples": 0}), grid, o, d, 1400.0, 1600.0)
    assert m.mask.shape == (64, 64) and m.active_count is None
    assert (mk.march_chain, mk.march_fused) == (0, 0)


def test_kernel_positions_take_the_chains_origin_gradient():
    """pose refinement: the kernels' positions plus (o - o.detach()) hold
    the chain's values and give the origins the chain's gradient, bit for
    bit."""
    gen = torch.Generator().manual_seed(3)
    o = (torch.randn((50, 3), generator=gen) * 100).requires_grad_(True)
    d = torch.randn((50, 3), generator=gen)
    t = torch.rand((50, 24), generator=gen) * 200 + 1400
    chain = o[..., None, :] + d[..., None, :] * t[..., None]
    kernel = occ._origin_grad(chain.detach(), o)
    assert torch.equal(kernel, chain)
    g = torch.randn(chain.shape, generator=gen)
    (want,) = torch.autograd.grad(chain, o, g)
    (got,) = torch.autograd.grad(kernel, o, g)
    assert torch.equal(got, want)
    detached = chain.detach()
    with torch.no_grad():
        assert occ._origin_grad(detached, o) is detached


# --- on the card ------------------------------------------------------------

_CT_NEAR, _CT_FAR = 1400.0, 1600.0


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ct(dev):
    """The CT cell's geometry: its dataset (26 views of 100x100 of the
    vessel phantom, source z 1500), 5,625 of its rays, the step-0 carved
    grid and a grid after 600 shipped steps."""
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_vessel_volume,
    )
    from nerf_for_angiography_tpu_torch.training import train

    ds = generate_dataset(make_vessel_volume(res=96), DatagenConfig(
        limited_size=180.0, number_angles=4.0, img_width=100, img_height=100,
        sample_outside=100.0, stratified_depths=False), device=dev)
    cfg = TrainConfig()
    res = train(dataclasses.replace(cfg, n_iters=600, display_every=300), ds.rays,
                src_pt_z=1500.0, verbose=False, device=dev)
    return dict(cfg=cfg, rays=ds.rays, sel=_pick(ds.rays.num_rays, 5625, dev),
                carved=_carved(ds.rays, cfg, _CT_NEAR, _CT_FAR, dev), trained=res.state.grid,
                near=_CT_NEAR, far=_CT_FAR)


@pytest.fixture(scope="module")
def lca(dev):
    """The LCA cell's geometry (the SDF tree's views at z 4000, here five of
    them), 5,625 rays and the carved step-0 grid."""
    from nerf_for_angiography_tpu_torch.data import generate_dataset, make_lca_sdf_volume
    from nerf_for_angiography_tpu_torch.data.datasets import sdf_datagen_config
    from nerf_for_angiography_tpu_torch.training import lca_protocol

    cfg, src_z = lca_protocol()
    ds = generate_dataset(make_lca_sdf_volume(), sdf_datagen_config(number_angles=1.0),
                          device=dev)
    near, far = src_z - cfg.outside, src_z + cfg.outside
    return dict(cfg=cfg, rays=ds.rays, sel=_pick(ds.rays.num_rays, 5625, dev),
                carved=_carved(ds.rays, cfg, near, far, dev), near=near, far=far)


def _pick(n: int, k: int, dev) -> torch.Tensor:
    return torch.randperm(n, generator=torch.Generator().manual_seed(7))[:k].to(dev)


def _carved(rays, cfg, near, far, dev):
    feas = occ.carve_feasible(rays.origins, rays.directions, rays.pixel_values,
                              [-cfg.outside] * 3 + [cfg.outside] * 3, cfg.grid_resolution,
                              near, far, thresh=cfg.carve_thresh)
    return occ.create_grid([-cfg.outside] * 3 + [cfg.outside] * 3, cfg.grid_resolution,
                           feasible=feas, device=dev)


def _fields(m) -> dict:
    if isinstance(m, occ.BucketedRays):
        return {**{f"lo.{k}": v for k, v in _fields(m.lo).items()},
                **{f"hi.{k}": v for k, v in _fields(m.hi).items()},
                "inv": m.inv, "perm": m.perm}
    return {k: v for k, v in m._asdict().items() if v is not None}


def _assert_same_bits(got, want, exact_zero_sign=True):
    g, w = _fields(got), _fields(want)
    assert g.keys() == w.keys()
    for k in w:
        a, b = g[k].detach(), w[k].detach()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == torch.float32 and exact_zero_sign:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f"{k}: {int((a != b).sum())} of {a.numel()} differ"


def _both(march, monkeypatch):
    """(kernel march, chain march) of ``march()`` on the card."""
    mk.reset_counts()
    fk.reset_counts()
    got = march()
    torch.cuda.synchronize()
    counts = (mk.launches, mk.march_fused, mk.march_chain, fk.launches)
    with monkeypatch.context() as mp:
        mp.setattr(occ, "takes_kernels", lambda device, shard=None: False)
        want = march()
    return got, want, counts


# each cell's Tunings: (config fields, launches the kernels make)
_LATTICE = lambda k: (dict(march_mode="lattice", compact_samples=k), 1)  # noqa: E731
_TWO_BUCKET = lambda k, k_lo, w_lo, w_cap: (dict(  # noqa: E731
    march_mode="hybrid", compact_samples=k, hybrid_k_lo=k_lo, hybrid_w_lo=w_lo,
    hybrid_w_cap=w_cap, hybrid_split=0.75, hybrid_bucket_k=True), 3)
_CT_TUNINGS = {
    "lattice96": _LATTICE(96), "lattice160": _LATTICE(160),
    "two_bucket": _TWO_BUCKET(96, 56, 48, 160), "two_bucket_k_lo40": _TWO_BUCKET(96, 40, 32, 128),
    "window96": (dict(march_mode="window", compact_samples=96), 1),
    "hybrid96": (dict(march_mode="hybrid", compact_samples=96, hybrid_split=0.0), 1),
    "hybrid2": (dict(march_mode="hybrid", compact_samples=96, hybrid_w_lo=48, hybrid_w_cap=160,
                     hybrid_split=0.75, hybrid_bucket_k=False), 3),
}
_LCA_TUNINGS = {
    "lattice192": _LATTICE(192), "two_bucket_k_lo56": _TWO_BUCKET(192, 56, 96, 224),
    "two_bucket_k_lo88": _TWO_BUCKET(192, 88, 160, 224),
    "window192": (dict(march_mode="window", compact_samples=192), 1),
}


def _check_tuning(cell, grid, tuning, monkeypatch):
    fields, want_launches = tuning
    cfg = dataclasses.replace(cell["cfg"], **fields)
    o = cell["rays"].origins.index_select(0, cell["sel"])
    d = cell["rays"].directions.index_select(0, cell["sel"])
    got, want, counts = _both(
        lambda: _march_for(cfg, grid, o, d, cell["near"], cell["far"]), monkeypatch)
    _assert_same_bits(got, want)
    assert counts == (want_launches, 1, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["carved", "trained"])
@pytest.mark.parametrize("tuning", sorted(_CT_TUNINGS))
def test_ct_marches_equal_the_chain(ct, grid, tuning, monkeypatch):
    """CT's Tunings (lattice k 96 / 160, which the Fourier cell runs too,
    two buckets with k_lo, and the chooser's window / hybrid / hybrid2) on
    the step-0 carved grid and a trained grid."""
    _check_tuning(ct, ct[grid], _CT_TUNINGS[tuning], monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("tuning", sorted(_LCA_TUNINGS))
def test_lca_marches_equal_the_chain(lca, tuning, monkeypatch):
    _check_tuning(lca, lca["carved"], _LCA_TUNINGS[tuning], monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [1, 2, 7, 33, 1000])
def test_ragged_batches_equal_the_chain(ct, n_rays, monkeypatch):
    """Batches that fill no block, and two buckets of one ray each."""
    ct = {**ct, "sel": ct["sel"][:n_rays]}
    for name in ("lattice160", "window96", "two_bucket"):
        fields, launches = _CT_TUNINGS[name]
        if n_rays < 2 and launches == 3:
            launches = 1  # one ray: no second bucket, the hybrid march
        _check_tuning(ct, ct["trained"], (fields, launches), monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("tuning", ["lattice160", "two_bucket"])
def test_pose_view_shift_gradient_equals_the_chain(ct, tuning, monkeypatch):
    """Origins that require grad (the view shifts' path): the positions and
    the shifts' gradient equal the chain's."""
    cfg = dataclasses.replace(ct["cfg"], **_CT_TUNINGS[tuning][0])
    sel = ct["sel"]
    ids = ct["rays"].image_ids.index_select(0, sel)
    o0 = ct["rays"].origins.index_select(0, sel)
    d = ct["rays"].directions.index_select(0, sel)
    shifts0 = (torch.rand((int(ids.max()) + 1, 3), generator=torch.Generator().manual_seed(5))
               - 0.5).to(o0.device)

    def run():
        # the step's shifted origins (training/train.py::shifted_origins)
        shifts = shifts0.clone().requires_grad_(True)
        o = o0 + _RowGather.apply(shifts, ids)
        m = _march_for(cfg, ct["trained"], o, d, ct["near"], ct["far"])
        parts = [m.lo, m.hi] if isinstance(m, occ.BucketedRays) else [m]
        gen = torch.Generator().manual_seed(11)
        loss = sum((p.positions * torch.randn(p.positions.shape, generator=gen).to(d.device))
                   .sum() for p in parts)
        loss.backward()
        return m, shifts.grad

    (got, got_g), (want, want_g), counts = _both(run, monkeypatch)
    _assert_same_bits(got, want, exact_zero_sign=False)
    assert torch.equal(got_g, want_g)
    assert counts[1:] == (1, 0, 0)


@pytest.mark.cuda
def test_strided_grid_tables_equal_the_chain(ct, monkeypatch):
    """A grid whose tables are strided views (as a grid read back from a
    file may hold): the kernels read contiguous copies of them."""
    g = ct["trained"]

    def strided(t):
        return t.transpose(0, 2).contiguous().transpose(0, 2)

    grid = g._replace(binary=strided(g.binary), coarse=strided(g.coarse))
    assert not grid.binary.is_contiguous() and torch.equal(grid.binary, g.binary)
    for name in ("lattice160", "two_bucket"):
        _check_tuning(ct, grid, _CT_TUNINGS[name], monkeypatch)


@pytest.mark.cuda
def test_replayed_march_equals_eager(ct):
    """The two-bucket march captured into a CUDA graph (its three launches)
    replays the eager march's bits."""
    cfg = dataclasses.replace(ct["cfg"], **_CT_TUNINGS["two_bucket"][0])
    o = ct["rays"].origins.index_select(0, ct["sel"])
    d = ct["rays"].directions.index_select(0, ct["sel"])
    eager = _march_for(cfg, ct["trained"], o, d, ct["near"], ct["far"])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _march_for(cfg, ct["trained"], o, d, ct["near"], ct["far"])
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        _assert_same_bits(captured, eager)


@pytest.mark.cuda
def test_march_kernels_refuse_what_they_do_not_take(ct):
    o = ct["rays"].origins[:64]
    d = ct["rays"].directions[:64]
    grid = ct["trained"]
    with pytest.raises(ValueError):
        mk.march_fine_cuda(o.double(), d.double(), grid.aabb, grid.binary, 300, 1400.0, 1600.0,
                           mk.LATTICE, 300, 96)
    with pytest.raises(ValueError):
        mk.march_fine_cuda(o, d.clone().requires_grad_(True), grid.aabb, grid.binary, 300,
                           1400.0, 1600.0, mk.LATTICE, 300, 96)
    with pytest.raises(ValueError):
        mk.march_buckets_cuda(o, d, grid.aabb, grid.binary, 300, 1400.0, 1600.0, 0,
                              (48, 56), (160, 96))
    n = mk._MAX_SORT_N + 1  # spans past the sort kernel's histograms
    with pytest.raises(ValueError, match="sort"):
        mk.march_buckets_cuda(o, d, grid.aabb, grid.binary, n, 1400.0, 1600.0, 32,
                              (48, 56), (160, 96), coarse=occ._window_plan(
                                  grid, n, 1400.0, 1600.0, None, None))
