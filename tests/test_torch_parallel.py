"""Port: data parallelism over ``torch.distributed`` (parallel/), the
counterpart of the JAX package's tests/test_parallel.py and
tests/test_distributed.py.

One world of two processes on the CPU (gloo, spawned once for the module,
rendezvous through a file store) runs every case at tiny sizes: 5-step loss
trajectories of the dense, lattice, two-bucket (hybrid2, hybrid2k), fused,
fourier and pose steps over the mesh against the single-process port's on
the same seeds (rtol 1e-4, the JAX tests' tolerance), the ranks' parameters
and grids bit for bit, a sharded train() (the ranks' Tuning, grids and
parameters equal; only rank 0 writes), the sharded sweep's df-metrics.csv
byte for byte against the unsharded sweep's, render_views_sharded against
the unsharded renders, the mesh helpers, and the refusals (an uneven
process split, a CUDA run under gloo, ranks whose decisions part). The
workers import the port only; JAX is imported by the tests that compare the
unsharded port with it."""

from __future__ import annotations

import hashlib
import os
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

NEAR, FAR = 1400.0, 1600.0
WORLD = 2
STEPS = 5
_SPHERE_DCFG = dict(limited_size=90.0, number_angles=1.0, img_width=16, img_height=16,
                    sample_outside=100.0, stratified_depths=False)
# the JAX tests' configurations (tests/test_parallel.py: tiny_cfg and the
# two-bucket cases), the MLP narrowed
_BASE = dict(depth_samples_per_ray=32, sample_size=16, grid_resolution=8, outside=100.0,
             n_iters=10, num_layers=2, num_hidden_units=32)
_HYB = dict(_BASE, depth_samples_per_ray=200, grid_resolution=32, march_mode="hybrid",
            compact_samples=48, hybrid_split=0.75, hybrid_w_lo=64, hybrid_w_cap=160)
STEP_CASES = {
    "dense": dict(_BASE),
    "lattice": dict(_BASE, depth_samples_per_ray=200, grid_resolution=32, compact_samples=48,
                    march_mode="lattice"),
    "hybrid2": dict(_HYB),
    "hybrid2k": dict(_HYB, hybrid_bucket_k=True, hybrid_k_lo=32),
    "fused dense": dict(_BASE, fused_train_step="on"),
    "fused hybrid2k": dict(_HYB, hybrid_bucket_k=True, hybrid_k_lo=32, fused_train_step="on"),
    "fourier": dict(_BASE, pos_enc="fourier", pos_enc_basis=4),
    "pose": dict(_BASE, pose_refine=True, pose_start=0),
}
PAGE = {
    "Category": ["Background"], "Sampling": ["Frangi sampling", "AccNeRF"],
    "Model architecture": "4x32", "Sparse projections": 4, "Limited projections": 90,
    "Data": "CT",
}
# the port's CLI test's tiny sizes (tests/test_torch_cli.py)
CLI_DATAGEN = ["--limited_size", "90", "--number_angles", "2", "--img_size", "16",
               "--volume", "phantom:sphere", "--out", "data", "--device", "cpu"]
CLI_TRAIN = ["--n_iters", "30", "--grid_resolution", "8", "--depth_samples", "32",
             "--display_every", "15", "--device", "cpu"]
CLI_EVALUATE = ["--data_name", "ct", "--volume", "phantom:sphere", "--number_angles_vis", "2",
                "--img_size", "16", "--depth_samples", "32", "--field_resolution", "9",
                "--no_videos", "--no_perceptual", "--device", "cpu"]
TRAIN_CFG = dict(depth_samples_per_ray=200, sample_size=12, grid_resolution=32, outside=50.0,
                 num_layers=2, num_hidden_units=32, n_iters=40, display_every=20)


def _digest(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _state_digest(state) -> dict:
    return dict(params=_digest(state.model.parameters()),
                grid=_digest([t for t in state.grid if t is not None]),
                vessel_grid=_digest([t for t in state.vessel_grid if t is not None]))


def _files(root: str) -> list[str]:
    if not os.path.isdir(root):
        return []
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _run_steps(cfg_kw: dict, rays, n_views: int, mesh):
    from nerf_for_angiography_tpu_torch.training import TrainConfig, create_train_state
    from nerf_for_angiography_tpu_torch.training import make_train_step

    cfg = TrainConfig(**cfg_kw)
    model, state = create_train_state(cfg, num_views=n_views, device="cpu")
    step = make_train_step(model, cfg, NEAR, FAR, mesh=mesh)
    losses, pressure = [], []
    for _ in range(STEPS):
        state, metrics, pred, _ = step(state, rays)
        losses.append(float(metrics["loss/train-pixel-coarse"]))
        pressure.append([int(metrics[k]) for k in ("march/over_k", "march/over_k_lo",
                                                    "march/edge_rays", "march/ac",
                                                    "march/ac_lo") if k in metrics])
    return dict(losses=losses, pressure=pressure, pred=pred.clone(), **_state_digest(state))


def _cases(rank: int, tmp: str, mesh) -> dict:
    """Every case on this rank; an exception is recorded as the case's
    result (the other rank would hang at its next collective, so the cases
    after a collective failure are cut by the parent's deadline)."""
    from nerf_for_angiography_tpu_torch.data import (
        DatagenConfig, generate_dataset, make_sphere_volume, make_vessel_volume,
        render_views_sharded,
    )
    from nerf_for_angiography_tpu_torch.evaluation import EvalConfig, gt_from_volume, run_sweep
    from nerf_for_angiography_tpu_torch.ops.interpolation import trilinear
    from nerf_for_angiography_tpu_torch.parallel import (
        collectives, create_mesh, data_sharding, process_local_slice, replicate, replicated,
        shard_leading_axis, shard_process_local,
    )
    from nerf_for_angiography_tpu_torch.training import TrainConfig, create_train_state, train

    out: dict = {}

    def case(name, fn):
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 - recorded for the parent's test to report
            out[name] = {"error": f"{type(e).__name__}: {e}\n{traceback.format_exc()}"}

    vol = make_sphere_volume(res=32, extent=75.0, radius=30.0, mu=0.02, device="cpu")
    data = generate_dataset(vol, DatagenConfig(**_SPHERE_DCFG), device="cpu")
    n_views = int(data.rays.image_ids.max()) + 1
    for name, kw in STEP_CASES.items():
        case(f"steps {name}", lambda kw=kw: {
            "sharded": _run_steps(kw, data.rays, n_views, mesh),
            # one process on the same seeds (rank 0 alone computes it)
            "single": _run_steps(kw, data.rays, n_views, None) if rank == 0 else None,
        })

    # a sharded train(), each rank given its own log_dir: only rank 0 writes
    vessel = generate_dataset(
        make_vessel_volume(res=48, extent=40.0, device="cpu"),
        DatagenConfig(limited_size=180.0, number_angles=4.0, img_width=32, img_height=32,
                      sample_outside=50.0, stratified_depths=False), device="cpu")

    def sharded_train():
        log_dir = os.path.join(tmp, f"train_rank{rank}")
        res = train(TrainConfig(**TRAIN_CFG), vessel.rays, src_pt_z=1500.0, log_dir=log_dir,
                    checkpoint_every=20, verbose=False, device="cpu", mesh=mesh)
        return dict(files=_files(log_dir), exists=os.path.exists(log_dir),
                    best_iter=res.best_iter, best_psnr=res.best_psnr, last_psnr=res.last_psnr,
                    tuning_final=res.timing["tuning_final"],
                    phases=[{k: p[k] for k in ("mode", "k", "w_cap", "w_lo", "k_lo", "steps")}
                            for p in res.timing["steady_phases"]],
                    **_state_digest(res.state))

    case("train", sharded_train)

    # the sweep: 3x3 views of 16x16 in batches of 2 a rank (the last batch's
    # second half all padding), the unsharded sweep beside it on rank 0
    ecfg = EvalConfig(limited_size_vis=90.0, number_angles_vis=2.0, img_width=16, img_height=16,
                      depth_samples_per_ray=32, outside=100.0, chunk_views=2, field_resolution=9,
                      save_videos=False)
    _, state = create_train_state(TrainConfig(**dict(_BASE, num_layers=4, num_hidden_units=32)),
                                  device="cpu")

    def sweep(tag, m):
        d = os.path.join(tmp, f"sweep_{tag}_rank{rank}")
        table = run_sweep(state.model, state.grid, ecfg, gt_from_volume(vol, ecfg), d,
                          page_data=PAGE, verbose=False, device="cpu",
                          gt_volume_sampler=lambda pts: trilinear(vol, pts), mesh=m)
        csv = os.path.join(d, "df-metrics.csv")
        return dict(files=_files(d), csv=open(csv, "rb").read() if os.path.exists(csv) else None,
                    psnr=np.asarray(table["PSNR"]), pred=np.asarray(table["pred_img"]),
                    dice3d=np.asarray(table["DICE 3D"]))

    case("sweep", lambda: {"sharded": sweep("sharded", mesh),
                           "single": sweep("single", None) if rank == 0 else None})

    def drr():
        depths = torch.linspace(NEAR, FAR, 64)
        got = {}
        for n in (8, 3):  # 3 views: padded to 4
            thetas = [0.0, 30.0, 60.0, 90.0, 120.0, 150.0, 180.0, 45.0][:n]
            args = (vol, thetas, [0.0] * n, [0.0, 0.0, 1500.0], 8, 8, 1300.0, depths)
            got[n] = (render_views_sharded(*args, mesh=mesh), render_views_sharded(*args))
        return got

    case("drr", drr)

    def helpers():
        x = torch.arange(16.0)
        local = x[process_local_slice(16)]
        try:
            process_local_slice(15)
            uneven = None
        except ValueError as e:
            uneven = str(e)
        # the JAX test_distributed case: a mean-loss gradient over local shards
        rs = np.random.RandomState(0)
        x_all = torch.from_numpy(rs.rand(16).astype(np.float32))
        y_all = torch.from_numpy((3.0 * x_all.numpy() + 0.1 * rs.rand(16)).astype(np.float32))
        sl = process_local_slice(16)
        b = shard_process_local({"x": x_all[sl], "y": y_all[sl]}, mesh)
        w = torch.tensor(1.5, requires_grad=True)
        (((w * b["x"] - b["y"]) ** 2).sum() / 16).backward()
        g = collectives.all_reduce_(w.grad.clone(), mesh)
        try:
            create_mesh(3)
            wrong_size = None
        except ValueError as e:
            wrong_size = str(e)
        try:
            collectives.agree(mesh, {"rank": rank}, "a test")
            parted = None
        except RuntimeError as e:
            parted = str(e)
        try:
            train(TrainConfig(**_BASE), data.rays, src_pt_z=1500.0, mesh=mesh, device="cuda")
            gloo_cuda = None
        except RuntimeError as e:
            gloo_cuda = str(e)
        return dict(
            local=local, uneven=uneven, grad=float(g),
            want=float(torch.mean(2.0 * (1.5 * x_all - y_all) * x_all)),
            shard=shard_leading_axis({"a": torch.arange(8), "b": [torch.arange(4)]}, mesh),
            replicated=replicate(torch.full((3,), float(rank)), mesh),
            parted=parted, gloo_cuda=gloo_cuda, wrong_size=wrong_size,
            placements=(repr(data_sharding(mesh)), repr(replicated(mesh))),
        )

    case("helpers", helpers)

    def clis():
        """datagen, train and evaluate as torchrun would launch them (its
        environment set; the group exists already) in one shared
        workspace: rank 0 alone renders the data, both ranks train and
        sweep over the mesh, rank 0 alone writes."""
        from nerf_for_angiography_tpu_torch.cli import datagen as c_datagen
        from nerf_for_angiography_tpu_torch.cli import evaluate as c_evaluate
        from nerf_for_angiography_tpu_torch.cli import train as c_train

        os.environ.update(WORLD_SIZE=str(WORLD), RANK=str(rank), LOCAL_RANK=str(rank))
        ws = os.path.join(tmp, "cli")
        os.makedirs(ws, exist_ok=True)
        os.chdir(ws)
        got = c_datagen.main(CLI_DATAGEN)
        torch.distributed.barrier()
        res = c_train.main(CLI_TRAIN)
        torch.distributed.barrier()
        tables = c_evaluate.main(CLI_EVALUATE)
        torch.distributed.barrier()
        return dict(datagen=got, runs=sorted(os.listdir(os.path.join("cases", "ct", "runs"))),
                    best_psnr=res.best_psnr, **_state_digest(res.state),
                    psnr={k: np.asarray(v["PSNR"]) for k, v in tables.items()},
                    files=_files(ws))

    case("cli", clis)
    return out


def _worker(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    from nerf_for_angiography_tpu_torch.parallel import create_mesh, initialize_multihost

    initialize_multihost(f"file://{tmp}/store", num_processes=WORLD, process_id=rank,
                         device="cpu")
    mesh = create_mesh()
    t0 = time.perf_counter()
    out = _cases(rank, tmp, mesh)
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' results (spawned once; killed past the deadline)."""
    tmp = str(tmp_path_factory.mktemp("world"))
    ctx = mp.start_processes(_worker, args=(tmp,), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 300
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError("the two-rank world did not finish in 300 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _ok(res):
    if isinstance(res, dict) and "error" in res:
        pytest.fail(res["error"])
    return res


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_steps_match_one_process(world, name):
    """5 sharded steps (each rank marching its share, one gradient
    all-reduce a step) give the single process's loss trajectory within
    rtol 1e-4, the same truncation pressure, the global batch's pixels; the
    ranks hold the same parameters and grids bit for bit."""
    r0, r1 = (_ok(w[f"steps {name}"]) for w in world)
    sh, single = r0["sharded"], r0["single"]
    np.testing.assert_allclose(sh["losses"], single["losses"], rtol=1e-4)
    assert sh["losses"] == r1["sharded"]["losses"]
    assert sh["pressure"] == single["pressure"]
    torch.testing.assert_close(sh["pred"], single["pred"], rtol=1e-4, atol=1e-5)
    for key in ("params", "grid", "vessel_grid"):
        assert sh[key] == r1["sharded"][key], key


def test_sharded_train_ranks_agree_and_one_writes(world):
    """train(mesh=) on both ranks: the same Tuning sequence, best iteration,
    PSNR, parameters and grids; rank 0 wrote the run directory (bundles,
    grid VTKs, readme, checkpoints) and rank 1 nothing."""
    r0, r1 = (_ok(w["train"]) for w in world)
    for key in ("best_iter", "best_psnr", "last_psnr", "tuning_final", "phases", "params",
                "grid", "vessel_grid"):
        assert r0[key] == r1[key], key
    assert r0["tuning_final"] is not None  # the compacted stepper engaged
    assert np.isfinite(r0["best_psnr"])
    assert {"highmodel.npz", "coarsegrid.vtk", "readme.txt"} <= set(r0["files"])
    assert any(f.startswith("ckpt/") for f in r0["files"])
    assert not r1["exists"] and r1["files"] == []


def test_sharded_sweep_csv_equals_one_process(world):
    """run_sweep(mesh=): df-metrics.csv byte for byte the unsharded sweep's,
    the same files written by rank 0 and none by rank 1, and every rank
    holding the whole table."""
    r0, r1 = (_ok(w["sweep"]) for w in world)
    sh, single = r0["sharded"], r0["single"]
    assert sh["csv"] is not None and sh["csv"] == single["csv"]
    assert sh["files"] == single["files"] and "df-metrics.csv" in sh["files"]
    assert r1["sharded"]["files"] == [] and r1["sharded"]["csv"] is None
    for key in ("psnr", "pred", "dice3d"):
        np.testing.assert_array_equal(r1["sharded"][key], sh[key])
        np.testing.assert_array_equal(single[key], sh[key])


def test_render_views_sharded_equals_unsharded(world):
    """Each rank renders its slice of the angles (3 views padded to 4);
    every rank gets all views, equal to the unsharded renders bit for bit."""
    for w in world:
        for n, (sharded, single) in _ok(w["drr"]).items():
            assert sharded.shape == (n, 8, 8)
            assert torch.equal(sharded, single)


def test_clis_under_torchrun(world):
    """The datagen, train and evaluate CLIs in a two-rank world as torchrun
    launches them: rank 0 alone renders the data; training and the sweep
    run over the mesh, the ranks ending on the same parameters, grids and
    metrics; one run directory, written by rank 0, holding the model
    bundle and df-metrics.csv."""
    r0, r1 = (_ok(w["cli"]) for w in world)
    assert r0["datagen"] is not None and r1["datagen"] is None
    assert len(r0["runs"]) == 1 and r0["runs"] == r1["runs"]
    for key in ("best_psnr", "params", "grid", "vessel_grid"):
        assert r0[key] == r1[key], key
    assert r0["psnr"].keys() == r1["psnr"].keys() and len(r0["psnr"]) == 1
    for k in r0["psnr"]:
        np.testing.assert_array_equal(r0["psnr"][k], r1["psnr"][k])
    run = f"cases/ct/runs/{r0['runs'][0]}/"
    assert {run + "highmodel.npz", run + "df-metrics.csv", run + "readme.txt"} <= set(r0["files"])


def test_mesh_helpers_and_refusals(world):
    """process_local_slice (raising on an uneven split, as JAX does), the
    all-reduced gradient of a mean loss over process-local shards equal to
    the single-process closed form on both ranks, shard_leading_axis,
    replicate (rank 0's values), the placements, a mesh over fewer ranks
    than the world refused, the decision check raising when the ranks part,
    and a CUDA run under gloo refused."""
    for rank, w in enumerate(world):
        h = _ok(w["helpers"])
        assert torch.equal(h["local"], torch.arange(16.0)[rank * 8:(rank + 1) * 8])
        assert "does not divide over 2" in h["uneven"]
        assert abs(h["grad"] - h["want"]) < 1e-6
        assert torch.equal(h["shard"]["a"], torch.arange(8)[rank * 4:(rank + 1) * 4])
        assert torch.equal(h["shard"]["b"][0], torch.arange(4)[rank * 2:(rank + 1) * 2])
        assert torch.equal(h["replicated"], torch.zeros(3))
        assert h["parted"] is not None and "differ" in h["parted"]
        assert h["gloo_cuda"] is not None and "NCCL" in h["gloo_cuda"]
        assert h["wrong_size"] is not None and "world size 2" in h["wrong_size"]
        assert h["placements"] == ("(Shard(dim=0),)", "(Replicate(),)")
    assert world[0]["helpers"]["grad"] == world[1]["helpers"]["grad"]


def test_parallel_exports_the_jax_names():
    import nerf_for_angiography_tpu.parallel as pj

    import nerf_for_angiography_tpu_torch.parallel as pt

    assert sorted(pt.__all__) == sorted(pj.__all__)
    for n in (0, 1, 7, 8, 9):
        assert pt.pad_to_multiple(n, 8) == pj.pad_to_multiple(n, 8)


def test_no_process_group_means_one_coordinator():
    from nerf_for_angiography_tpu_torch.parallel import is_coordinator, process_local_slice

    assert is_coordinator()
    assert process_local_slice(7) == slice(0, 7)


def test_initialize_multihost_refusals(monkeypatch):
    """No world size or rank, no coordinator address, or a card that is not
    there: initialize_multihost raises before joining anything."""
    from nerf_for_angiography_tpu_torch.parallel import initialize_multihost

    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        initialize_multihost("localhost:1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        initialize_multihost(num_processes=2, process_id=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            initialize_multihost("localhost:1", 2, 0, device="cuda")


def test_unsharded_drr_views_match_jax():
    """render_views_sharded without a mesh against the JAX function on the
    JAX test's angles (the sharded renders equal these bit for bit)."""
    import jax.numpy as jnp
    from nerf_for_angiography_tpu.data import make_sphere_volume as make_sphere_volume_j
    from nerf_for_angiography_tpu.data import render_views_sharded as render_views_sharded_j

    from nerf_for_angiography_tpu_torch.data import make_sphere_volume, render_views_sharded

    thetas = [0.0, 30.0, 60.0, 90.0, 120.0, 150.0, 180.0, 45.0]
    want = render_views_sharded_j(
        make_sphere_volume_j(res=32), jnp.array(thetas), jnp.zeros(8),
        np.array([0, 0, 1500.0]), 8, 8, 1300.0, jnp.linspace(NEAR, FAR, 64))
    got = render_views_sharded(make_sphere_volume(res=32, device="cpu"), thetas, [0.0] * 8,
                               [0.0, 0.0, 1500.0], 8, 8, 1300.0, torch.linspace(NEAR, FAR, 64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_step_cases_are_the_jax_configurations():
    """The two-bucket cases are the JAX tests' configurations (only the MLP
    narrowed): each marches two buckets."""
    from nerf_for_angiography_tpu_torch.training import TrainConfig

    for name in ("hybrid2", "hybrid2k"):
        cfg = TrainConfig(**STEP_CASES[name])
        assert 0 < cfg.compact_samples < cfg.depth_samples_per_ray
        assert cfg.hybrid_split == 0.75 and cfg.hybrid_w_lo == 64
