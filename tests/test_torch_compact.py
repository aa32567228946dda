"""Port: the compacted march chain against the JAX package on the same
inputs (numpy from a seed, grids and weights copied across). Integer-valued
outputs (masks, active counts, edge flags, window indices, bucket
permutations, chooser stats, sizers, tuner decisions, pressure) must match
exactly; t and positions within tests/test_torch_occupancy.py's tolerance;
loss and gradients of a compacted step within tests/test_torch_train.py's."""

import dataclasses
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.ops import occupancy as oj
from nerf_for_angiography_tpu.training import TrainConfig as TrainConfigJ
from nerf_for_angiography_tpu.training import create_train_state as create_train_state_j
from nerf_for_angiography_tpu.training import pressure as pj
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
from nerf_for_angiography_tpu_torch.data import DatagenConfig, generate_dataset, make_vessel_volume
from nerf_for_angiography_tpu_torch.ops import occupancy as ot
from nerf_for_angiography_tpu_torch.ops.kernels import first_k as fk
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_for_angiography_tpu_torch.ops.sampling import RayBatch
from nerf_for_angiography_tpu_torch.training import TrainConfig, create_train_state, train
from nerf_for_angiography_tpu_torch.training import pressure as pt

# the training packages export train(), which shadows the module's name
tj = importlib.import_module("nerf_for_angiography_tpu.training.train")
tt = importlib.import_module("nerf_for_angiography_tpu_torch.training.train")

AABB = [-100.0] * 3 + [100.0] * 3
NEAR, FAR = 1400.0, 1600.0
N = 64  # samples per ray


def _rays(n=160, seed=0):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-20, 20, (n, 2))
    o[:, 2] = 1500.0
    target = rng.uniform(-110, 110, (n, 3)).astype(np.float32)
    target[:, 2] = 0.0
    return o, ((target - o) / 1500.0).astype(np.float32)


def _blob_binary(res, seed=1):
    """Six balls of occupied cells: sparse, so windows and spans vary."""
    rng = np.random.default_rng(seed)
    idx = np.stack(np.meshgrid(*[np.arange(res) + 0.5] * 3, indexing="ij"), -1)
    binary = np.zeros((res,) * 3, bool)
    for _ in range(6):
        c = rng.uniform(0.2, 0.8, 3) * res
        r = rng.uniform(0.06, 0.14) * res
        binary |= ((idx - c) ** 2).sum(-1) < r * r
    return binary


def _grids(res):
    b = _blob_binary(res)
    gj = oj.with_packed(oj.OccupancyGrid(
        occs=jnp.zeros((res,) * 3, jnp.float32), binary=jnp.asarray(b), aabb=jnp.asarray(AABB)))
    return gj, ot.grid_from_numpy(b, AABB)


def _inputs(res, n_rays=160):
    gj, gt = _grids(res)
    o, d = _rays(n_rays)
    return (gj, jnp.asarray(o), jnp.asarray(d)), (gt, torch.from_numpy(o), torch.from_numpy(d))


def _assert_march_equal(mt, mj):
    np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
    for name in ("active_count", "edge_active"):
        a, b = getattr(mt, name), getattr(mj, name)
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("t_starts", "t_ends"):
        np.testing.assert_allclose(getattr(mt, name).numpy(), np.asarray(getattr(mj, name)),
                                   rtol=1e-6)
    np.testing.assert_allclose(mt.positions.numpy(), np.asarray(mj.positions),
                               rtol=1e-6, atol=1e-4)


def _assert_equal(got, want):
    if isinstance(want, oj.BucketedRays):
        assert isinstance(got, ot.BucketedRays)
        _assert_march_equal(got.lo, want.lo)
        _assert_march_equal(got.hi, want.hi)
        np.testing.assert_array_equal(got.inv.numpy(), np.asarray(want.inv))
        np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    elif isinstance(want, oj.MarchedRays):
        assert isinstance(got, ot.MarchedRays)
        _assert_march_equal(got, want)
    else:  # coarse_window's (start, end, any_hit)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# each case: (JAX call, port call) on (module, grid, origins, directions)
EXT = dict(aabb_extent=200.0)
MARCHES = {
    "coarse_window": lambda M, g, o, d: M.coarse_window(g, o, d, N, NEAR, FAR, **EXT),
    "coarse_window_from_aabb": lambda M, g, o, d: M.coarse_window(g, o, d, N, NEAR, FAR),
    "window": lambda M, g, o, d: M.march_rays_window(g, o, d, N, NEAR, FAR, k=24, **EXT),
    "window_wide_k": lambda M, g, o, d: M.march_rays_window(g, o, d, N, NEAR, FAR, k=60, **EXT),
    "lattice": lambda M, g, o, d: M.march_rays(g, o, d, N, NEAR, FAR, compact_k=20),
    "lattice_strided": lambda M, g, o, d: M.march_rays(g, o, d, N, NEAR, FAR, compact_k=20,
                                                       occ_stride=2),
    "hybrid": lambda M, g, o, d: M.march_rays_hybrid(g, o, d, N, NEAR, FAR, k=20, w_cap=40,
                                                     occ_stride=2, **EXT),
    "hybrid_default_w_cap": lambda M, g, o, d: M.march_rays_hybrid(g, o, d, N, NEAR, FAR, k=16,
                                                                   **EXT),
    "hybrid2": lambda M, g, o, d: M.march_rays_hybrid2(g, o, d, N, NEAR, FAR, k=20, w_lo=24,
                                                       w_cap=48, occ_stride=2, **EXT),
    "hybrid2k": lambda M, g, o, d: M.march_rays_hybrid2k(g, o, d, N, NEAR, FAR, k=20, k_lo=12,
                                                         w_lo=24, w_cap=48, occ_stride=2, **EXT),
    "hybrid2k_k_exceeds_w": lambda M, g, o, d: M.march_rays_hybrid2k(
        g, o, d, N, NEAR, FAR, k=56, k_lo=40, w_lo=16, w_cap=48, **EXT),
    # the fall-backs of march_rays_hybrid2 / march_rays_hybrid2k
    "hybrid2_w_lo_covers": lambda M, g, o, d: M.march_rays_hybrid2(
        g, o, d, N, NEAR, FAR, k=20, w_lo=48, w_cap=48, **EXT),
    "hybrid2_one_bucket": lambda M, g, o, d: M.march_rays_hybrid2(
        g, o, d, N, NEAR, FAR, k=20, w_lo=24, w_cap=48, split=0.001, **EXT),
    "hybrid2k_k_lo_reaches_k": lambda M, g, o, d: M.march_rays_hybrid2k(
        g, o, d, N, NEAR, FAR, k=20, k_lo=24, w_lo=24, w_cap=48, occ_stride=2, **EXT),
    "hybrid2k_w_lo_covers": lambda M, g, o, d: M.march_rays_hybrid2k(
        g, o, d, N, NEAR, FAR, k=20, k_lo=12, w_lo=56, w_cap=48, **EXT),
    "hybrid2k_split_all": lambda M, g, o, d: M.march_rays_hybrid2k(
        g, o, d, N, NEAR, FAR, k=20, k_lo=12, w_lo=24, w_cap=48, split=1.0, **EXT),
    "hybrid2k_one_ray": lambda M, g, o, d: M.march_rays_hybrid2k(
        g, o[:1], d[:1], N, NEAR, FAR, k=20, k_lo=12, w_lo=24, w_cap=48, **EXT),
}


@pytest.mark.parametrize("res", [16, 64])  # coarse_factor 1 and 2
@pytest.mark.parametrize("case", sorted(MARCHES))
def test_march_matches_jax(case, res):
    (gj, oj_, dj), (gt, ot_, dt) = _inputs(res)
    want = MARCHES[case](oj, gj, oj_, dj)
    got = MARCHES[case](ot, gt, ot_, dt)
    _assert_equal(got, want)
    if isinstance(want, oj.MarchedRays):
        assert 0 < float(want.mask.sum()) < want.mask.size  # a non-trivial mask


def test_fka_pallas_name_gives_the_same_march():
    (_, _, _), (gt, o, d) = _inputs(16)
    a = ot.march_rays_hybrid2k(gt, o, d, N, NEAR, FAR, k=20, k_lo=12, w_lo=24, w_cap=48,
                               occ_stride=2, fka="pallas", **EXT)
    b = ot.march_rays_hybrid2k(gt, o, d, N, NEAR, FAR, k=20, k_lo=12, w_lo=24, w_cap=48,
                               occ_stride=2, fka="xla", **EXT)
    for x, y in zip([*a.lo, *a.hi, a.inv], [*b.lo, *b.hi, b.inv]):
        assert torch.equal(x, y)


def test_coarse_table_cached_and_rebuilt():
    gj, gt = _grids(64)
    assert gt.coarse_factor == 2 and gt.coarse.shape == (32, 32, 32)
    want, _ = ot.coarse_dilated_grid(gt.binary, 2)
    assert torch.equal(gt.coarse, want)
    # the JAX bit-packed table holds the same bits
    bits = np.asarray(oj.pack_grid_bits(jnp.asarray(gt.coarse.numpy())))
    np.testing.assert_array_equal(bits, np.asarray(gj.packed_coarse))
    # an EMA update rebinarizes and rebuilds the table
    g2, _ = ot.update_grid_pair(gt, gt, lambda p: torch.zeros(p.shape[0]), 1e-4, 5e-2)
    assert not g2.binary.any() and not g2.coarse.any()


def _cfgs(**kw):
    base = dict(depth_samples_per_ray=N, compact_samples=24, outside=100.0)
    base.update(kw)
    return TrainConfigJ(**base), TrainConfig(**base)


@pytest.mark.parametrize("res", [16, 64])
@pytest.mark.parametrize("split", [0.0, 0.75])
def test_chooser_stats_match_jax(res, split):
    (gj, oj_, dj), (gt, ot_, dt) = _inputs(res)
    cj, ct = _cfgs(hybrid_split=split)
    want = tj._chooser_stats(cj, gj, oj_, dj, NEAR, FAR)
    got = tt._chooser_stats(ct, gt, ot_, dt, NEAR, FAR)
    assert got == want and all(type(v) is int for v in got)
    assert min(got[:3]) > 0 and (got[3] > 0) == (split > 0)


CHOOSER_CFGS = {
    "window_default": dict(),
    "window_no_interim": dict(compact_engage_max=0),
    "window_wide": dict(compact_samples=60),
    "window_single_k": dict(hybrid_bucket_k=False),
    "hybrid": dict(march_mode="hybrid"),
    "hybrid_one_bucket": dict(march_mode="hybrid", hybrid_split=0.0),
    "lattice": dict(march_mode="lattice"),
    "none_fits": dict(compact_samples=8, compact_engage_max=0),
    "compaction_off": dict(compact_samples=0),
}


@pytest.mark.parametrize("res", [16, 64])
@pytest.mark.parametrize("name", sorted(CHOOSER_CFGS))
def test_choose_compact_mode_matches_jax(name, res):
    (gj, oj_, dj), (gt, ot_, dt) = _inputs(res)
    cj, ct = _cfgs(**CHOOSER_CFGS[name])
    want = tj.choose_compact_mode(cj, gj, oj_, dj, NEAR, FAR)
    got = tt.choose_compact_mode(ct, gt, ot_, dt, NEAR, FAR)
    assert (got is None) == (want is None)
    if want is not None:
        assert tuple(got) == tuple(want)
    if ct.compact_samples:
        for mode in ("window", "hybrid", "lattice"):
            assert tt.compact_switch_width(ct, gt, ot_, dt, NEAR, FAR, mode) == \
                tj.compact_switch_width(cj, gj, oj_, dj, NEAR, FAR, mode)


SIZER_CFGS = [dict(), dict(compact_engage_max=0), dict(compact_k_margin=1.0),
              dict(compact_samples=64, compact_engage_max=300)]


@pytest.mark.parametrize("sizer", ["compact_k_for", "compact_k_lo_for", "hybrid_w_cap_for",
                                   "hybrid_w_lo_for", "_max_hybrid_w_cap"])
def test_sizers_match_jax(sizer):
    cases = 0
    for kw in SIZER_CFGS:
        cj, ct = TrainConfigJ(**kw), TrainConfig(**kw)
        for a in range(0, 320, 3):
            for b in (0, 16, 40, 96, 128, 192, 300):
                args = {
                    "compact_k_for": ((a, cj), (a, ct)),
                    "compact_k_lo_for": ((a, b, cj), (a, b, ct)),
                    "hybrid_w_cap_for": ((a, b or 1),) * 2,
                    "hybrid_w_lo_for": ((a, b),) * 2,
                    "_max_hybrid_w_cap": ((a or 1,),) * 2,
                }[sizer]
                assert getattr(tt, sizer)(*args[1]) == getattr(tj, sizer)(*args[0])
                cases += 1
    assert cases > 1000


@pytest.mark.parametrize("case", ["window", "lattice", "hybrid", "hybrid2", "hybrid2k",
                                  "hybrid2k_k_exceeds_w"])
def test_march_pressure_matches_jax(case):
    (gj, oj_, dj), (gt, ot_, dt) = _inputs(64)
    want = tj.march_pressure(MARCHES[case](oj, gj, oj_, dj))
    got = tt.march_pressure(MARCHES[case](ot, gt, ot_, dt))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.int32 and got[k].shape == ()
        assert int(got[k]) == int(v), k
    assert int(got["march/ac"]) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pressure_tuner_matches_jax(seed):
    """Both tuners driven side by side through one seeded random sequence of
    engage / observe / retune / resolve / decay calls: equal Tuning and equal
    tuner state after every call."""
    rng = np.random.default_rng(seed)
    cj, ct = TrainConfigJ(), TrainConfig()
    tun_j, tun_t = pj.PressureTuner(display_every=100), pt.PressureTuner(display_every=100)
    t_j, t_t = pj.Tuning(), pt.Tuning()

    def choice():
        mode = str(rng.choice(["window", "hybrid", "lattice"]))
        width = int(rng.integers(8, 200))
        w_cap = int(rng.choice([160, 176, 192, 224])) if mode == "hybrid" else 0
        w_lo = int(rng.choice([0, 32, 48, 64])) if w_cap else 0
        width_lo = int(rng.integers(0, w_lo + 1)) if w_lo else 0
        args = (mode, width, w_cap, w_lo, width_lo)
        return tj.CompactChoice(*args), tt.CompactChoice(*args)

    m = 0
    for _ in range(300):
        m += 50
        op = rng.choice(["engage", "observe", "retune", "resolve", "decay"],
                        p=[0.05, 0.45, 0.25, 0.15, 0.10])
        if op == "engage":
            a, b = choice()
            t_j, t_t = tun_j.engage(a, cj), tun_t.engage(b, ct)
        elif op == "observe":
            quiet = rng.random() < 0.5
            stats = [0, 0, 0] if quiet else [int(v) for v in rng.integers(0, 40, 3)]
            stats += [int(v) for v in rng.integers(0, 200, 2)]
            tun_j.observe(m, *stats)
            tun_t.observe(m, *stats)
        elif op == "retune":
            a, b = choice()
            t_j, t_t = tun_j.retune(t_j, a, cj), tun_t.retune(t_t, b, ct)
        elif op == "resolve":
            changed, recheck = bool(rng.random() < 0.5), int(rng.choice([100, 200]))
            tun_j.resolve(m, changed, recheck)
            tun_t.resolve(m, changed, recheck)
        else:
            m = -(-m // 100) * 100
            tun_j.decay_if_quiet(m)
            tun_t.decay_if_quiet(m)
        assert dataclasses.asdict(t_t) == dataclasses.asdict(t_j)
        assert dataclasses.asdict(tun_t) == dataclasses.asdict(tun_j)
    assert tun_t.fired + tun_t.muted > 0 and tun_t.k_floor > 0


def test_compacted_step_matches_jax():
    """One train step at a fixed hybrid2k Tuning against the JAX render's
    value_and_grad on the same grid, weights and rays: loss and pressure,
    normalised parameter gradients, pixel order."""
    kw = dict(
        sample_size=8, depth_samples_per_ray=N, grid_resolution=16, num_layers=2,
        num_hidden_units=32, sampling_strategy="random", coarse_lr=1e-3,
        march_mode="hybrid", compact_samples=24, hybrid_w_cap=48, hybrid_w_lo=24,
        hybrid_split=0.75, hybrid_bucket_k=True, hybrid_k_lo=12,
    )
    cfg_j = TrainConfigJ(**kw, mlp_backend="xla", compute_dtype="bfloat16")
    cfg_t = TrainConfig(**kw)
    (gj, o_j, d_j), (gt, o_t, d_t) = _inputs(16, n_rays=64)
    target = np.random.default_rng(4).uniform(0.3, 1.0, 64).astype(np.float32)

    model_j, state_j = create_train_state_j(cfg_j, jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, state_j.params)

    def loss_fn(params):
        pix, _, _, m = tj.render_rays(model_j, params, gj, o_j, d_j, cfg_j, NEAR, FAR,
                                      return_march=True)
        return jnp.mean((pix - jnp.asarray(target)) ** 2), (pix, tj.march_pressure(m))

    (loss_j, (pix_j, pres_j)), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params0))

    model_t, state_t = create_train_state(cfg_t, device="cpu")
    model_t.load_state_dict(cppn_params_from_jax(params0))
    state_t.grid, state_t.vessel_grid, state_t.step = gt, gt, 1  # no grid update at step 1
    step_t = tt.make_train_step(model_t, cfg_t, NEAR, FAR)
    batch = RayBatch(o_t, d_t, torch.from_numpy(target), torch.zeros(64, dtype=torch.int64))
    fk.reset_counts()
    state_t, metrics_t, pix_t, _ = step_t.step_core(state_t, batch)
    assert fk.launches == 0  # the plain version on the CPU

    assert isinstance(tt._march_for(cfg_t, gt, o_t, d_t, NEAR, FAR), ot.BucketedRays)
    assert float(metrics_t["loss/train-pixel-coarse"]) == pytest.approx(float(loss_j), rel=2e-2)
    np.testing.assert_allclose(pix_t.numpy(), np.asarray(pix_j), atol=2e-2)
    for k, v in pres_j.items():
        assert int(metrics_t[k]) == int(v), k
    grads_t = {n: p.grad for n, p in model_t.named_parameters()}
    for name, g_j in cppn_params_from_jax(jax.tree.map(np.asarray, grads_j)).items():
        if name in ("img1", "img2"):
            continue
        want = g_j.numpy()
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(grads_t[name].numpy() / scale, want / scale, atol=3e-2)


@pytest.fixture(scope="module")
def vessel_rays():
    ds = generate_dataset(
        make_vessel_volume(res=48, extent=40.0),
        DatagenConfig(limited_size=180.0, number_angles=4.0, img_width=48, img_height=48,
                      sample_outside=50.0, stratified_depths=False),
        device="cpu",
    )
    return ds.rays


@pytest.mark.parametrize("march_mode", ["window", "hybrid"])
def test_tiny_train_engages_compaction_on_cpu(vessel_rays, march_mode, capsys):
    """train() at the compaction defaults (only the sizes cut) engages the
    compacted stepper at iteration 0 after carving, steps it, and launches
    no kernel on the CPU."""
    cfg = TrainConfig(
        depth_samples_per_ray=200, sample_size=12, grid_resolution=32, outside=50.0,
        num_layers=2, num_hidden_units=32, n_iters=40, display_every=20,
        march_mode=march_mode,
    )
    fk.reset_counts()
    fm.reset_counts()
    res = train(cfg, vessel_rays, src_pt_z=1500.0, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert "switching to compacted stepper at iter 0" in out
    assert fk.launches == 0 and fm.fwd_launches == 0 and fm.bwd_launches == 0
    phases = res.timing["steady_phases"]
    assert sum(p["steps"] for p in phases) == 40  # every step after iteration 0
    assert res.timing["dense_rays"] == cfg.img_sample_size  # iteration 0
    assert res.timing["tuning_final"] is not None and res.timing["step_compact"] > 0
    assert np.isfinite(res.best_heldout_psnr) and np.isfinite(res.last_psnr)


# ---------------------------------------------------------------------------
# the loop's pressure latency: both train() loops driven by the same scripted
# steps (every step builder, the eval, the chooser and the train state
# stubbed inside the test; neither package changes)
# ---------------------------------------------------------------------------

loop_j = importlib.import_module("nerf_for_angiography_tpu.training.loop")
loop_t = importlib.import_module("nerf_for_angiography_tpu_torch.training.loop")

_SCRIPT_CFG = dict(n_iters=600, display_every=500, sampling_strategy="random",
                   carve_init=False)


def _pressure_at(i, fires):
    """A compacted step's (over_k, over_k_lo, edge_rays, ac, ac_lo) at
    iteration i: 40 samples over k at the iterations in ``fires`` (the
    tuner keeps the last observed chunk's, so pressure that lasts past the
    chunk that fired is what a retune grows by)."""
    return (40 if i in fires else 0, 0, 0, 80, 0)


def _recording_tuner(base, issued, observed):
    class Recording(base):
        def observe(self, m, *stats):
            observed.append((m, issued[0]))  # (boundary, steps issued by then)
            super().observe(m, *stats)

    return Recording


def _drive_jax(monkeypatch, width, fires, issued, observed):
    cfg = TrainConfigJ(**_SCRIPT_CFG)

    def metrics_of(c, i0, n):
        if not 0 < c.compact_samples < c.depth_samples_per_ray:
            return {}
        rows = np.array([_pressure_at(i, fires) for i in range(i0, i0 + n)], np.int32)
        return {k: jnp.asarray(rows[:, j]) for j, k in enumerate(loop_j._PRESSURE_KEYS)}

    def make_step(model, c, near, far, **kw):
        def step(state, rays):
            mets = {k: v[0] for k, v in metrics_of(c, issued[0], 1).items()}
            issued[0] += 1
            return state, mets, jnp.zeros(1), jnp.zeros(1)
        return step

    def make_chunk(model, c, near, far, n, **kw):
        def chunk(state, rays):
            mets = metrics_of(c, issued[0], n)
            issued[0] += n
            return state, mets, jnp.zeros(1), jnp.zeros(1)
        return chunk

    evals = {"psnr/test-coarse": 20.0, "psnr/vessel-test-coarse": 20.0,
             "loss/test-pixel-coarse": 0.01}
    monkeypatch.setattr(loop_j, "create_train_state", lambda *a, **k: (None, type("S", (), {
        "grid": None})()))
    monkeypatch.setattr(loop_j, "make_test_view", lambda *a, **k: type("T", (), {
        "origins": None, "directions": None})())
    monkeypatch.setattr(loop_j, "drop_test_view", lambda r, *a: r)
    monkeypatch.setattr(loop_j, "make_train_step", make_step)
    monkeypatch.setattr(loop_j, "make_train_chunk", make_chunk)
    monkeypatch.setattr(loop_j, "make_eval_step", lambda *a, **k: lambda s, t: (evals, None))
    monkeypatch.setattr(tj, "choose_compact_mode",
                        lambda *a, **k: tj.CompactChoice("lattice", width))
    monkeypatch.setattr(loop_j, "PressureTuner",
                        _recording_tuner(pj.PressureTuner, issued, observed))
    rays = type("R", (), {"num_rays": 10**6})()
    loop_j.train(cfg, rays, src_pt_z=1500.0, rays_per_view=100, verbose=True)


def _drive_torch(monkeypatch, width, fires, issued, observed):
    cfg = TrainConfig(**_SCRIPT_CFG)

    class Chunk:
        """n scripted steps in one call (or ``steps``: a partial chunk),
        their pressure reduced into the loop's buffer as make_train_chunk
        reduces it."""

        compile_s = 0.0

        def __init__(self, c, n, pressure):
            self.compacted = 0 < c.compact_samples < c.depth_samples_per_ray
            self.n, self.pressure = n, pressure

        def __call__(self, state, rays, steps=None):
            n = self.n if steps is None else steps
            rows = [_pressure_at(i, fires) for i in range(issued[0], issued[0] + n)]
            mets = {}
            if self.compacted:
                mets = {k: torch.tensor(v, dtype=torch.int32)
                        for k, v in zip(tt.PRESSURE_KEYS, rows[-1])}
                self.pressure.copy_(torch.tensor(rows, dtype=torch.int32).amax(dim=0))
            issued[0] += n
            return state, mets, None, None

    def make_chunk(model, c, near, far, n, pool=None, pressure=None, num_images=None,
                   rays_per_image=None):
        return Chunk(c, n, pressure)

    evals = {"psnr/test-coarse": 20.0, "psnr/vessel-test-coarse": 20.0,
             "loss/test-pixel-coarse": 0.01}
    rays = type("R", (), {"num_rays": 10**6, "to": lambda self, d: self})()
    monkeypatch.setattr(loop_t, "create_train_state", lambda *a, **k: (None, type("S", (), {
        "grid": None})()))
    monkeypatch.setattr(loop_t, "make_test_view", lambda *a, **k: type("T", (), {
        "origins": None, "directions": None})())
    monkeypatch.setattr(loop_t, "drop_test_view", lambda r, *a: r)
    monkeypatch.setattr(loop_t, "make_train_chunk", make_chunk)
    monkeypatch.setattr(loop_t, "make_eval_step", lambda *a, **k: lambda s, t: (evals, None))
    monkeypatch.setattr(loop_t, "choose_compact_mode",
                        lambda *a, **k: tt.CompactChoice("lattice", width))
    monkeypatch.setattr(loop_t, "PressureTuner",
                        _recording_tuner(pt.PressureTuner, issued, observed))
    loop_t.train(cfg, rays, src_pt_z=1500.0, rays_per_view=100, verbose=True, device="cpu")


@pytest.mark.parametrize("width,fires,first_observe,retunes", [
    # settled k = 96 (re-check = display_every 500): the chunk ending at 100
    # is observed once 101..200 are issued, and its fire retunes at 200
    (80, range(50, 200), (100, 201), [200]),
    # k = 160 on the interim ladder (re-check = check_every 100): the chunk
    # is observed at its own boundary and retunes there
    (120, range(50, 200), (100, 101), [100]),
    # a fire in the chunk ending at 400 (settled) retunes at 500
    (80, range(350, 500), (100, 201), [500]),
])
def test_loop_observes_pressure_with_the_jax_latency(monkeypatch, capsys, width, fires,
                                                      first_observe, retunes):
    """The port's train() and the JAX train() on the same scripted steps:
    tuner.observe sees each chunk at the same boundary after the same number
    of issued steps, and the Tuning changes at the same iterations (a full
    chunk's pressure waits for the next chunk, JAX loop.py:468-475; drains
    early at a re-check, a fire, a display boundary and the last iteration,
    :528-538)."""
    runs = {}
    for side, drive in (("jax", _drive_jax), ("torch", _drive_torch)):
        issued, observed = [0], []
        drive(monkeypatch, width, fires, issued, observed)
        out = capsys.readouterr().out
        runs[side] = (observed, [int(n) for n in re.findall(r"retuning compacted stepper at "
                                                            r"iter (\d+)", out)], issued[0])
    assert runs["torch"] == runs["jax"]
    observed, got_retunes, n_steps = runs["torch"]
    assert n_steps == _SCRIPT_CFG["n_iters"] + 1
    assert observed[0] == first_observe
    assert got_retunes == retunes
    # every full chunk is observed once, at most one chunk late
    assert [m for m, _ in observed] == list(range(100, 601, 100))
    assert all(m + 1 <= n <= m + 101 for m, n in observed)
